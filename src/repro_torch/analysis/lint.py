"""AST lint tier: run the repo-specific rules over a package tree.

:func:`lint_tree` walks every ``*.py`` under a package root, parses it
once, runs the per-file rules (:data:`repro_torch.analysis.rules.FILE_RULES`)
and the cross-file rules (reference-pairing needs the whole tree plus
the test corpus), and filters findings through the inline
``# repro: allow[rule]`` suppressions. Baseline filtering is the
caller's job (:mod:`repro_torch.analysis.__main__`) so tests can assert on raw
rule output.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from repro_torch.analysis import rules as rules_pkg
from repro_torch.analysis.findings import Finding, scan_suppressions


@dataclass
class LintResult:
    findings: list = field(default_factory=list)
    suppressed: list = field(default_factory=list)
    files_scanned: int = 0
    parse_errors: list = field(default_factory=list)


def _iter_sources(root):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d != "__pycache__"
        )
        for name in sorted(filenames):
            if name.endswith(".py"):
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                yield rel, full


def lint_tree(src_root, tests_root=None, *,
              file_rules=rules_pkg.FILE_RULES,
              tree_rules=rules_pkg.TREE_RULES) -> LintResult:
    """Lint the package at *src_root*; rel paths in findings are relative
    to it (e.g. ``codec/decode.py``). *tests_root* feeds the cross-file
    reference-pairing rule; ``None`` skips tree rules entirely (fixture
    runs)."""
    result = LintResult()
    parsed = []  # (relpath, tree, suppressions)
    for rel, full in _iter_sources(src_root):
        with open(full, encoding="utf-8") as fh:
            source = fh.read()
        result.files_scanned += 1
        try:
            tree = ast.parse(source, filename=full)
        except SyntaxError as e:
            result.parse_errors.append(
                Finding("parse-error", rel, e.lineno or 0, str(e))
            )
            continue
        supp = scan_suppressions(source)
        parsed.append((rel, tree, supp))
        for rule in file_rules:
            for f in rule.check_file(rel, tree, source):
                (result.suppressed if supp.allows(f.rule, f.line)
                 else result.findings).append(f)

    if tests_root is not None and tree_rules:
        test_sources = []
        for _, full in _iter_sources(tests_root):
            with open(full, encoding="utf-8") as fh:
                test_sources.append(fh.read())
        supp_by_path = {rel: supp for rel, _, supp in parsed}
        files = [(rel, tree) for rel, tree, _ in parsed]
        for rule in tree_rules:
            for f in rule.check_tree(files, test_sources):
                supp = supp_by_path.get(f.path)
                (result.suppressed if supp and supp.allows(f.rule, f.line)
                 else result.findings).append(f)

    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return result
