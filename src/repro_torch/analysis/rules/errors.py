"""typed-errors: wire failures are structured; handlers don't swallow.

The codec's error contract: anything wrong with
container bytes surfaces as :class:`ContainerFormatError` carrying
``stream=``/``offset=``/``unit=`` so callers (and the salvage decoder)
can quarantine precisely. Two checks enforce it:

**Repo-wide handler discipline** — a bare ``except:`` or a broad
``except Exception/BaseException`` is a finding *unless* the handler
body re-raises (``raise`` anywhere in the handler: the convert-and-raise
idiom is the sanctioned use of broad catches). Deliberate swallowing
sites carry ``# repro: allow[typed-errors]`` with a reason.

**Parse-path raise discipline** — inside the wire-parsing modules, in
parse scopes (``__init__`` of ``*Reader``/``*Directory``/``*Latents``
classes; functions named ``_unpack*``, ``_decode*``, ``verify_*``,
``from_*``):

* every ``raise ContainerFormatError(...)`` must pass at least one of
  ``stream=``/``offset=``/``unit=`` — an unlocated wire error defeats
  salvage;
* every other raise must be a bare re-raise — an untyped exception
  escaping a parse path bypasses the structured contract.

``core/gae.py`` is deliberately outside the parse-path scope: its
``from_parts`` raises unlocated ``ContainerFormatError`` by design and
``runtime._species_guarantee`` adds the stream/unit framing upstream.
"""

from __future__ import annotations

import ast
import fnmatch

from repro_torch.analysis.findings import Finding

RULE = "typed-errors"

#: Modules whose parse scopes must speak ContainerFormatError.
PARSE_MODULES = frozenset({
    "codec/format.py",
    "codec/runtime.py",
    "codec/latents.py",
    "codec/partial.py",
    "codec/integrity.py",
    "core/container.py",
})

_PARSE_FUNC_PATTERNS = ("_unpack*", "_decode*", "verify_*", "from_*")
_PARSE_CLASS_SUFFIXES = ("Reader", "Directory", "Latents")
_STRUCTURED_KWARGS = frozenset({"stream", "offset", "unit"})
_BROAD = frozenset({"Exception", "BaseException"})


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        if isinstance(n, ast.Name) and n.id in _BROAD:
            return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


def _is_parse_scope(func: ast.AST, cls_name: str | None) -> bool:
    name = func.name
    if name == "__init__" and cls_name is not None:
        return cls_name.endswith(_PARSE_CLASS_SUFFIXES)
    return any(fnmatch.fnmatch(name, p) for p in _PARSE_FUNC_PATTERNS)


def _check_raise(node: ast.Raise, relpath: str, scope: str) -> Finding | None:
    if node.exc is None:  # bare re-raise: propagating a typed error
        return None
    exc = node.exc
    fn = exc.func if isinstance(exc, ast.Call) else exc
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None
    )
    if name != "ContainerFormatError":
        return Finding(
            RULE, relpath, node.lineno,
            f"parse scope {scope!r} raises {name or 'a computed exception'}"
            f" instead of ContainerFormatError",
        )
    kwargs = {k.arg for k in exc.keywords} if isinstance(exc, ast.Call) else set()
    if not kwargs & _STRUCTURED_KWARGS:
        return Finding(
            RULE, relpath, node.lineno,
            f"ContainerFormatError in parse scope {scope!r} lacks "
            f"stream=/offset=/unit=",
        )
    return None


def check_file(relpath: str, tree: ast.AST, source: str) -> list[Finding]:
    out = []
    # repo-wide: broad handlers that swallow
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            if _is_broad(node) and not _reraises(node):
                what = "bare except" if node.type is None else (
                    "broad except swallowing"
                )
                out.append(Finding(
                    RULE, relpath, node.lineno,
                    f"{what} without re-raise",
                ))

    if relpath not in PARSE_MODULES:
        return out

    # parse-path raise discipline, scoped to named parse functions
    def visit(node, cls_name):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _is_parse_scope(child, cls_name):
                    for sub in ast.walk(child):
                        if isinstance(sub, ast.Raise):
                            f = _check_raise(sub, relpath, child.name)
                            if f is not None:
                                out.append(f)
                else:
                    visit(child, None)

    visit(tree, None)
    return out
