"""reference-pairing: every retained ``*_ref`` twin is test-gated.

The repo's optimization discipline (ROADMAP): every fused/compiled path
retains its pre-change reference implementation, and a test pins parity
between the two. A ``*_reference``/``*_ref`` function no test ever
touches is a parity gate that silently stopped gating — the fused path
can drift and nothing fails.

Cross-file pass: collect every function definition in the package
whose name ends in ``_reference`` or ``_ref`` and require the name to
occur (as a whole word) somewhere under ``tests/``. Kernel
*parameters* conventionally named ``*_ref`` are not definitions and are
not collected.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.findings import Finding

RULE = "reference-pairing"

_SUFFIXES = ("_reference", "_ref")


def reference_defs(files) -> list[tuple[str, int, str]]:
    """(relpath, line, name) of every ``*_ref(erence)`` def in *files*,
    given as (relpath, tree) pairs."""
    out = []
    for relpath, tree in files:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name.endswith(_SUFFIXES):
                    out.append((relpath, node.lineno, node.name))
    return out


def check_tree(files, test_sources) -> list[Finding]:
    """*files*: (relpath, tree) pairs for the package; *test_sources*:
    iterable of test-file text."""
    corpus = "\n".join(test_sources)
    out = []
    for relpath, line, name in reference_defs(files):
        if not re.search(rf"\b{re.escape(name)}\b", corpus):
            out.append(Finding(
                RULE, relpath, line,
                f"reference symbol {name!r} is not exercised by any test "
                f"under tests/",
            ))
    return out
