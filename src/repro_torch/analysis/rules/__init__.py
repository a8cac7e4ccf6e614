"""Rule registry for the AST lint tier.

Each rule module exposes ``RULE`` (its name, used in findings, inline
``# repro: allow[rule]`` tags, and the baseline) and ``check_file(relpath,
tree, source)`` returning a list of findings for one module.
:mod:`repro_torch.analysis.rules.pairing` is the one cross-file rule and
instead exposes ``check_tree(files, test_sources)``.

The first five rules are the JAX package's, with its names, scopes and
messages (the port's tree mirrors the reference's, so the scopes carry
over); the last two hold what only the port has to keep: no import of JAX
or the reference, and the kernel wrappers' launch-or-raise contract.
"""

from __future__ import annotations

from repro_torch.analysis.rules import (determinism, errors, kernel_wrapper, pairing,
                                        purity, reference_import, wire)

#: The reference's per-file rules, in its report order.
SHARED_FILE_RULES = (purity, wire, errors, determinism)

#: The port's own per-file rules.
PORT_FILE_RULES = (reference_import, kernel_wrapper)

#: Per-file rules, in report order.
FILE_RULES = SHARED_FILE_RULES + PORT_FILE_RULES

#: Cross-file rules (run once over the whole tree).
TREE_RULES = (pairing,)

ALL_RULE_NAMES = tuple(
    [r.RULE for r in FILE_RULES] + [r.RULE for r in TREE_RULES]
)
