"""kernel-wrapper: launch or raise; no silent fallback, no dropped gradient.

The wrappers of the hand-written CUDA kernels are the one place where the
port meets its kernels, and the contract of every one of them is the same
(``kernels/_wrap.py``): refuse an operand that would need a gradient
(no kernel has a backward), check, launch, raise on a refused launch. A
wrapper that caught a failed launch and returned the plain version would
make a broken build look like a working kernel; one that checked the
gradient after launching would drop it silently.

In the five wrapper modules, every public function that reaches
``_wrap.launch`` (directly or through the module's own helpers) must:

* make ``refuse_grad(...)`` its first statement after the docstring;
* have no ``except`` handler around a launch that does not re-raise;
* reach no plain version of ``kernels/ref.py`` except under an explicit
  CPU-device branch (``if <tensor>.device.type == "cpu":`` and the like:
  an ``if`` comparing with the literal ``"cpu"``).
"""

from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

RULE = "kernel-wrapper"

WRAPPER_MODULES = frozenset({
    "kernels/gbatc_project.py",
    "kernels/flash_attention.py",
    "kernels/block_quant.py",
    "kernels/rglru_scan.py",
    "kernels/rwkv6_scan.py",
})

_WRAP = "_wrap"
_REF = "ref"


def _imports(tree: ast.AST):
    """(local names of ``_wrap.launch`` / ``_wrap.refuse_grad``, aliases of
    the ``_wrap`` module, aliases of the ``ref`` module, names imported
    from ``ref``)."""
    wrap_names: dict[str, str] = {}
    wrap_mods, ref_mods, ref_names = set(), set(), set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        mod = (node.module or "").split(".")
        for alias in node.names:
            local = alias.asname or alias.name
            if mod[-1] == _WRAP and alias.name in ("launch", "refuse_grad"):
                wrap_names[local] = alias.name
            elif mod[-1] == _REF:
                ref_names.add(local)
            elif mod[-1] == "kernels" or (node.level and not node.module):
                if alias.name == _WRAP:
                    wrap_mods.add(local)
                elif alias.name == _REF:
                    ref_mods.add(local)
    return wrap_names, wrap_mods, ref_mods, ref_names


class _Module:
    def __init__(self, tree: ast.AST):
        self.wrap_names, self.wrap_mods, self.ref_mods, self.ref_names = \
            _imports(tree)
        self.funcs = {n.name: n for n in tree.body
                      if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self._reaches: dict[str, bool] = {}

    def wrap_call(self, node: ast.AST) -> str | None:
        """'launch' / 'refuse_grad' if ``node`` calls that ``_wrap`` helper."""
        if not isinstance(node, ast.Call):
            return None
        fn = node.func
        if isinstance(fn, ast.Name):
            return self.wrap_names.get(fn.id)
        if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                and fn.value.id in self.wrap_mods
                and fn.attr in ("launch", "refuse_grad")):
            return fn.attr
        return None

    def ref_call(self, node: ast.AST) -> str | None:
        """The plain version's name if ``node`` calls one of ``ref``."""
        if not isinstance(node, ast.Call):
            return None
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in self.ref_names:
            return fn.id
        if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                and fn.value.id in self.ref_mods):
            return fn.attr
        return None

    def callees(self, func: ast.AST) -> set[str]:
        return {n.func.id for n in ast.walk(func)
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id in self.funcs}

    def reaches_launch(self, name: str, seen=()) -> bool:
        if name not in self._reaches:
            func = self.funcs[name]
            direct = any(self.wrap_call(n) == "launch" for n in ast.walk(func))
            self._reaches[name] = direct or any(
                self.reaches_launch(c, seen + (name,))
                for c in self.callees(func) if c not in seen + (name,))
        return self._reaches[name]

    def launches(self, node: ast.AST) -> bool:
        """``node`` holds a call that launches (directly or via a helper)."""
        for n in ast.walk(node):
            if self.wrap_call(n) == "launch":
                return True
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id in self.funcs
                    and self.reaches_launch(n.func.id)):
                return True
        return False


def _body_without_docstring(func) -> list:
    body = list(func.body)
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        body = body[1:]
    return body


def _cpu_test(test: ast.AST) -> str | None:
    """'body' if ``test`` is ``x == "cpu"``, 'orelse' if ``x != "cpu"``."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return None
    sides = (test.left, test.comparators[0])
    if not any(isinstance(s, ast.Constant) and s.value == "cpu" for s in sides):
        return None
    if isinstance(test.ops[0], (ast.Eq, ast.Is)):
        return "body"
    if isinstance(test.ops[0], (ast.NotEq, ast.IsNot)):
        return "orelse"
    return None


def _ref_calls_outside_cpu(mod: _Module, node: ast.AST, on_cpu: bool = False):
    """Yield (call node, name) of every plain-version call under ``node``
    that no enclosing CPU-device branch guards."""
    if isinstance(node, ast.If):
        branch = _cpu_test(node.test)
        yield from _ref_calls_outside_cpu(mod, node.test, on_cpu)
        for stmt in node.body:
            yield from _ref_calls_outside_cpu(mod, stmt, on_cpu or branch == "body")
        for stmt in node.orelse:
            yield from _ref_calls_outside_cpu(mod, stmt,
                                              on_cpu or branch == "orelse")
        return
    if isinstance(node, ast.IfExp):
        branch = _cpu_test(node.test)
        yield from _ref_calls_outside_cpu(mod, node.test, on_cpu)
        yield from _ref_calls_outside_cpu(mod, node.body, on_cpu or branch == "body")
        yield from _ref_calls_outside_cpu(mod, node.orelse,
                                          on_cpu or branch == "orelse")
        return
    name = mod.ref_call(node)
    if name is not None and not on_cpu:
        yield node, name
    for child in ast.iter_child_nodes(node):
        yield from _ref_calls_outside_cpu(mod, child, on_cpu)


def _helpers(mod: _Module, name: str) -> list[str]:
    """``name`` and the module functions it calls, transitively."""
    order, todo = [], [name]
    while todo:
        cur = todo.pop()
        if cur in order:
            continue
        order.append(cur)
        todo.extend(sorted(mod.callees(mod.funcs[cur]) - set(order)))
    return order


def check_file(relpath: str, tree: ast.AST, source: str) -> list[Finding]:
    if relpath not in WRAPPER_MODULES:
        return []
    mod = _Module(tree)
    out, seen_ref = [], set()
    for name, func in mod.funcs.items():
        if name.startswith("_") or not mod.reaches_launch(name):
            continue
        body = _body_without_docstring(func)
        first = body[0] if body else None
        if not (isinstance(first, ast.Expr)
                and mod.wrap_call(first.value) == "refuse_grad"):
            out.append(Finding(
                RULE, relpath, (first or func).lineno,
                f"wrapper {name!r} does not refuse gradients first: its first "
                f"statement is not refuse_grad(...)",
            ))
        for node in ast.walk(func):
            if isinstance(node, ast.Try) and any(mod.launches(s) for s in node.body):
                for handler in node.handlers:
                    if not any(isinstance(n, ast.Raise) for n in ast.walk(handler)):
                        out.append(Finding(
                            RULE, relpath, handler.lineno,
                            f"handler in wrapper {name!r} catches a launch "
                            f"without re-raising: launch or raise, no silent "
                            f"fallback",
                        ))
        for helper in _helpers(mod, name):
            for call, ref in _ref_calls_outside_cpu(mod, mod.funcs[helper]):
                if (call.lineno, ref) in seen_ref:
                    continue
                seen_ref.add((call.lineno, ref))
                out.append(Finding(
                    RULE, relpath, call.lineno,
                    f"wrapper {name!r} reaches the plain version {ref!r} "
                    f"outside an explicit CPU-device branch",
                ))
    return out
