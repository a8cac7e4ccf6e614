"""Invariant checker of the port: lint, trace audit, wire schema.

The counterpart of the JAX package's ``analysis`` package: three analyzer
tiers over one findings currency
(:class:`~repro_torch.analysis.findings.Finding`):

1. **AST lint** (:mod:`repro_torch.analysis.lint` +
   :mod:`repro_torch.analysis.rules`) — the reference's five rules over
   ``src/repro_torch`` (decode-path purity, wire centralization,
   typed-error discipline, determinism hygiene, reference pairing) and
   two of the port's own (no JAX or reference import; the kernel
   wrappers' launch-or-raise contract).
2. **Trace audit** (:mod:`repro_torch.analysis.trace_audit`) — runs the
   registered hot programs under a ``TorchDispatchMode`` (and on the card
   under ``torch.cuda.set_sync_debug_mode("error")``) and checks what the
   reference's jaxpr walk checks: fp64 promotion, host syncs, mid-program
   transfers, captured constants, in-place carries, collectives where
   expected, the cached decode runtime.
3. **Wire-schema conformance** (:mod:`repro_torch.analysis.wire_schema`) —
   a declarative restatement of container v1–v5 diffed against the live
   pack/parse constants; also owns the fault-region label vocabulary
   (:class:`~repro_torch.analysis.wire_schema.RegionKind`).

Run::

    PYTHONPATH=src python -m repro_torch.analysis               # on the GPU
    PYTHONPATH=src python -m repro_torch.analysis --device cpu  # anywhere

Suppress a deliberate violation inline (``# repro: allow[rule]`` /
``# repro: allow-file[rule]``) or grandfather it in
``src/repro_torch/analysis/baseline.json``; the CLI exits nonzero on any
new finding.
"""

from repro_torch.analysis.findings import Finding, Suppressions, scan_suppressions
from repro_torch.analysis.lint import LintResult, lint_tree
from repro_torch.analysis.wire_schema import (
    GUARANTEE_PARTS,
    RegionKind,
    check_conformance,
)

__all__ = [
    "Finding",
    "GUARANTEE_PARTS",
    "LintResult",
    "RegionKind",
    "Suppressions",
    "check_conformance",
    "lint_tree",
    "scan_suppressions",
]
