"""CLI: ``python -m repro_torch.analysis`` — run all three analyzer tiers.

Exit status 0 iff no non-baselined finding. Options:

* ``--root DIR``      package root to lint (default: the ``src/repro_torch``
  tree this module lives in)
* ``--tests DIR``     tests root for the reference-pairing rule
  (default: ``<repo>/tests`` when resolvable, else skipped)
* ``--baseline PATH`` baseline file (default: ``analysis/baseline.json``)
* ``--no-audit``      skip the (slower) trace audit tier
* ``--json PATH``     dump a machine-readable report
* ``--write-baseline`` rewrite the baseline to the current finding set
* ``--device {cuda,cpu}`` where the audit runs its programs (default: the
  GPU; without CUDA that raises — there is no CPU fallback)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.analysis import wire_schema
from repro_torch.analysis.findings import apply_baseline, load_baseline, save_baseline
from repro_torch.analysis.lint import lint_tree

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _default_tests_root() -> str | None:
    # src/repro_torch -> repo root -> tests
    repo = os.path.dirname(os.path.dirname(_PKG_ROOT))
    tests = os.path.join(repo, "tests")
    return tests if os.path.isdir(tests) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--root", default=_PKG_ROOT)
    ap.add_argument("--tests", default=None)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--no-audit", action="store_true")
    ap.add_argument("--json", dest="json_path", default=None)
    ap.add_argument("--write-baseline", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    tests_root = args.tests or _default_tests_root()
    baseline_path = args.baseline or os.path.join(
        args.root, "analysis", "baseline.json"
    )

    result = lint_tree(args.root, tests_root)
    findings = list(result.findings) + list(result.parse_errors)
    lint_s = time.perf_counter() - t0

    findings += wire_schema.check_conformance()

    audit_report = None
    if not args.no_audit:
        from repro_torch.analysis import trace_audit

        audit_report = trace_audit.audit(args.device)
        findings += audit_report.findings

    baseline = load_baseline(baseline_path) if os.path.exists(
        baseline_path
    ) else []
    new, baselined, stale = apply_baseline(findings, baseline)

    if args.write_baseline:
        save_baseline(baseline_path, findings)
        print(f"baseline written: {len(findings)} finding(s) -> "
              f"{baseline_path}")
        return 0

    rule_counts: dict[str, int] = {}
    for f in findings:
        rule_counts[f.rule] = rule_counts.get(f.rule, 0) + 1

    for f in new:
        print(str(f))
    for f in baselined:
        print(f"baselined: {f}")
    for r in stale:
        print(f"warning: stale baseline entry "
              f"[{r['rule']}] {r['path']}: {r['detail']}")

    total_s = time.perf_counter() - t0
    print(
        f"repro_torch.analysis: {result.files_scanned} files, "
        f"{len(findings)} finding(s) "
        f"({len(new)} new, {len(baselined)} baselined, "
        f"{len(result.suppressed)} suppressed inline), "
        f"lint {lint_s:.2f}s, total {total_s:.2f}s"
        + ("" if args.no_audit else
           f", audit {audit_report.wall_clock_s:.2f}s on {audit_report.device}")
    )

    if args.json_path:
        payload = {
            "files_scanned": result.files_scanned,
            "rule_counts": rule_counts,
            "new": [f.__dict__ for f in new],
            "baselined": [f.__dict__ for f in baselined],
            "suppressed_inline": len(result.suppressed),
            "stale_baseline": stale,
            "lint_wall_clock_s": lint_s,
            "audit_wall_clock_s": (
                None if audit_report is None else audit_report.wall_clock_s
            ),
            "total_wall_clock_s": total_s,
        }
        with open(args.json_path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)

    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
