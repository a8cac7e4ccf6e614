"""determinism: no unseeded randomness, no wall-clock in cache keys.

GBATC's bit-identity gates (fused vs reference decode, v3/v4 byte
identity) only mean something if every run is reproducible. Two families
of ambient nondeterminism are banned:

* **Unseeded randomness** (everywhere in the linted package): the stdlib
  ``random`` module (always implicitly process-seeded), the legacy
  ``np.random.*`` global-state API (``seed``/``rand``/``randn``/
  ``randint``/``random``/``normal``/``uniform``/``choice``/``shuffle``/
  ``permutation``), and zero-argument ``default_rng()`` (OS-entropy
  seeded). Seeded ``np.random.default_rng(seed)`` and a seeded
  ``torch.Generator`` are the sanctioned sources.
* **Wall-clock in codec/core/parallel state** (``codec/``, ``core/``,
  ``parallel/``): ``time.time``/``perf_counter``/``monotonic`` and
  ``datetime.now``/``utcnow`` — a timestamp reaching a cache key or a
  wire byte makes identical inputs produce different artifacts, and the
  mesh-sharded fit/compress programs (``parallel/``) carry the same
  bit-identity gates as the single-device paths. Benchmark and launch
  code may time things freely.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

RULE = "determinism"

_NP_RANDOM_LEGACY = frozenset({
    "seed", "rand", "randn", "randint", "random", "normal", "uniform",
    "choice", "shuffle", "permutation", "random_sample", "standard_normal",
})
_CLOCK_SCOPES = ("codec/", "core/", "parallel/")
_TIME_FUNCS = frozenset({"time", "perf_counter", "monotonic"})
_DATETIME_FUNCS = frozenset({"now", "utcnow", "today"})


def _dotted(node) -> list[str]:
    """Attribute chain -> name parts, e.g. np.random.rand -> [np,random,rand]."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def check_file(relpath: str, tree: ast.AST, source: str) -> list[Finding]:
    out = []
    in_clock_scope = relpath.startswith(_CLOCK_SCOPES)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import,)):
            for alias in node.names:
                if alias.name == "random":
                    out.append(Finding(
                        RULE, relpath, node.lineno,
                        "stdlib random imported (process-seeded global "
                        "state); use np.random.default_rng(seed)",
                    ))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "random":
                out.append(Finding(
                    RULE, relpath, node.lineno,
                    "stdlib random imported (process-seeded global "
                    "state); use np.random.default_rng(seed)",
                ))
        elif isinstance(node, ast.Call):
            parts = _dotted(node.func)
            if len(parts) >= 2 and parts[-2] == "random" \
                    and parts[-1] in _NP_RANDOM_LEGACY \
                    and parts[0] in ("np", "numpy"):
                out.append(Finding(
                    RULE, relpath, node.lineno,
                    f"legacy global-state np.random.{parts[-1]}; use a "
                    f"seeded Generator",
                ))
            elif parts and parts[-1] == "default_rng" and not node.args \
                    and not node.keywords:
                out.append(Finding(
                    RULE, relpath, node.lineno,
                    "default_rng() without a seed draws OS entropy",
                ))
            elif in_clock_scope and len(parts) == 2:
                mod, fn = parts
                if (mod == "time" and fn in _TIME_FUNCS) or (
                        mod == "datetime" and fn in _DATETIME_FUNCS):
                    out.append(Finding(
                        RULE, relpath, node.lineno,
                        f"wall-clock {mod}.{fn}() in codec/core — "
                        f"timestamps must not reach cache keys or wire "
                        f"bytes",
                    ))
    return out
