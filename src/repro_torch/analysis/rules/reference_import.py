"""reference-import: the port imports neither JAX nor the reference package.

``repro_torch`` is a PyTorch/CUDA port that runs where JAX is not
installed; the JAX package (``repro``) is the reference its tests hold it
against, never a dependency. A module that imported either would fail on
the GPU machine, or quietly make the port's results the reference's.

Flags, everywhere in the package:

* ``import jax`` / ``import jaxlib`` / ``import repro`` and their dotted
  forms (``import jax.numpy as jnp``);
* ``from jax... import`` / ``from jaxlib... import`` / ``from repro...
  import`` (``repro_torch`` itself is a different top-level name and is
  fine; relative imports stay inside the package);
* ``importlib.import_module("jax...")`` / ``__import__("repro...")`` with
  a literal module name.

This is the static half of ``tests/test_torch_imports.py``, which also
imports every module with those packages blocked.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

RULE = "reference-import"

FORBIDDEN = frozenset({"jax", "jaxlib", "repro"})


def _root(dotted: str | None) -> str | None:
    return None if not dotted else dotted.split(".")[0]


def _dynamic_target(node: ast.Call) -> str | None:
    """The literal module name of ``importlib.import_module("...")`` or
    ``__import__("...")``, else None."""
    fn = node.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None
    )
    if name not in ("import_module", "__import__") or not node.args:
        return None
    arg = node.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return None


def check_file(relpath: str, tree: ast.AST, source: str) -> list[Finding]:
    out = []
    for node in ast.walk(tree):
        modules = []
        if isinstance(node, ast.Import):
            modules = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            modules = [node.module]
        elif isinstance(node, ast.Call):
            target = _dynamic_target(node)
            modules = [target] if target else []
        for mod in modules:
            if _root(mod) in FORBIDDEN:
                out.append(Finding(
                    RULE, relpath, node.lineno,
                    f"imports {mod!r}: the port must not depend on JAX or "
                    f"the reference package",
                ))
    return out
