"""Structured findings, inline suppression tags, and the baseline file.

Every analyzer in :mod:`repro_torch.analysis` reports through one currency — a
:class:`Finding` naming the rule that fired, where, and why. Two escape
hatches keep the gate honest without blocking deliberate exceptions:

* an inline ``# repro: allow[rule]`` tag on the offending line (or
  ``# repro: allow-file[rule]`` anywhere in the file for a file-wide
  waiver) suppresses at the source, next to a comment saying why;
* a checked-in baseline (``analysis/baseline.json``) grandfathers
  findings by ``(rule, path, detail)`` — line numbers are deliberately
  ignored so unrelated edits above a baselined site don't resurrect it.

The CLI exits nonzero on any finding that is neither tagged nor
baselined. Stale baseline entries (nothing matches them any more) are
reported as warnings, not failures, so fixes don't require a lockstep
baseline edit.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

_ALLOW_LINE = re.compile(r"#\s*repro:\s*allow\[([a-z0-9_,-]+)\]")
_ALLOW_FILE = re.compile(r"#\s*repro:\s*allow-file\[([a-z0-9_,-]+)\]")


@dataclass(frozen=True)
class Finding:
    """One invariant violation: which rule, where, and what it saw."""

    rule: str
    path: str
    line: int
    detail: str

    def key(self) -> tuple[str, str, str]:
        """Baseline identity — line numbers intentionally excluded."""
        return (self.rule, self.path, self.detail)

    def __str__(self) -> str:  # CLI display form
        return f"{self.path}:{self.line}: [{self.rule}] {self.detail}"


@dataclass
class Suppressions:
    """Inline allow tags scanned from one source file."""

    line_rules: dict[int, frozenset] = field(default_factory=dict)
    file_rules: frozenset = frozenset()

    def allows(self, rule: str, line: int) -> bool:
        if rule in self.file_rules or "*" in self.file_rules:
            return True
        rules = self.line_rules.get(line, frozenset())
        return rule in rules or "*" in rules


def scan_suppressions(source: str) -> Suppressions:
    """Collect ``# repro: allow[...]`` / ``allow-file[...]`` tags.

    A line tag covers its own physical line; rule names may be
    comma-separated (``allow[wire-centralization,typed-errors]``).
    """
    line_rules: dict[int, frozenset] = {}
    file_rules: set = set()
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _ALLOW_FILE.search(text)
        if m:
            file_rules.update(r.strip() for r in m.group(1).split(","))
            continue
        m = _ALLOW_LINE.search(text)
        if m:
            rules = frozenset(r.strip() for r in m.group(1).split(","))
            line_rules[lineno] = line_rules.get(lineno, frozenset()) | rules
    return Suppressions(line_rules=line_rules, file_rules=frozenset(file_rules))


def load_baseline(path) -> list[dict]:
    """Read a baseline file -> list of {rule, path, detail} records."""
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return []
    if not isinstance(data, dict) or not isinstance(data.get("findings"), list):
        raise ValueError(f"malformed baseline file {path!r}")
    return data["findings"]


def save_baseline(path, findings) -> None:
    records = sorted(
        ({"rule": f.rule, "path": f.path, "detail": f.detail} for f in findings),
        key=lambda r: (r["rule"], r["path"], r["detail"]),
    )
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"findings": records}, fh, indent=2, sort_keys=True)
        fh.write("\n")


def apply_baseline(findings, baseline_records):
    """Split findings into (new, baselined) and report stale entries.

    Returns ``(new, baselined, stale)`` where *stale* is the subset of
    baseline records matching no current finding.
    """
    keys = {(r["rule"], r["path"], r["detail"]) for r in baseline_records}
    new, baselined = [], []
    matched: set = set()
    for f in findings:
        if f.key() in keys:
            baselined.append(f)
            matched.add(f.key())
        else:
            new.append(f)
    stale = [r for r in baseline_records
             if (r["rule"], r["path"], r["detail"]) not in matched]
    return new, baselined, stale
