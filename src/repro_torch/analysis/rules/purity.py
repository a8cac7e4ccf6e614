"""decode-purity: decode derives structure from the blob alone.

Everything under ``codec/`` and ``serve/`` must reconstruct purely from
container bytes — never from ambient pipeline configuration or the
process environment. A decode that silently consulted
``default_config()`` or an env var would produce blobs that only decode
on the machine (or config) that wrote them, breaking the paper's
self-describing-container contract; the decode service serves whatever
blobs are registered with it, so the same contract covers the serving
layer wholesale.

Since the encoder-family refactor the rule is structural, not just
symbolic: the codec packages the family-owned
:class:`~repro_torch.codec.families.StructuralConfig` unpacked from the blob,
so **no import of** ``repro_torch.core.pipeline`` — the encode-side
orchestration module — is permitted anywhere under the scope, at any
nesting level. (``repro_torch.codec.__getattr__`` re-exports ``GBATCCodec``
through ``importlib`` by module-name string precisely so the seam stays
visible to this check: an AST import of the pipeline under ``codec/``
is always a regression.)

Flags, inside the scoped trees:

* any ``import``/``from ... import`` of ``repro_torch.core.pipeline`` (the
  ambient-config symbols ``GBATCPipeline`` / ``default_config`` keep
  their dedicated message; any other alias flags the module import
  itself);
* ``os.environ`` / ``os.getenv`` / ``os.environb`` reads;
* calling ``PipelineConfig()`` with no arguments — a fresh
  default-valued config is ambient state by construction; the decode
  path must rebuild its config from the meta stream.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

RULE = "decode-purity"

SCOPE_PREFIXES = ("codec/", "serve/")

_BANNED_MODULE = "core.pipeline"
_BANNED_IMPORTS = frozenset({"GBATCPipeline", "default_config"})
_ENV_ATTRS = frozenset({"environ", "environb", "getenv"})


def in_scope(relpath: str) -> bool:
    return relpath.startswith(SCOPE_PREFIXES)


def _is_pipeline_module(dotted: str | None) -> bool:
    return dotted is not None and (
        dotted == _BANNED_MODULE or dotted.endswith("." + _BANNED_MODULE)
    )


def check_file(relpath: str, tree: ast.AST, source: str) -> list[Finding]:
    if not in_scope(relpath):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            from_pipeline = _is_pipeline_module(node.module)
            for alias in node.names:
                if alias.name in _BANNED_IMPORTS:
                    # the historical, sharper message wins per alias
                    out.append(Finding(
                        RULE, relpath, node.lineno,
                        f"decode path imports ambient-config symbol "
                        f"{alias.name!r}",
                    ))
                elif from_pipeline or (
                    # `from repro_torch.core import pipeline` spells the same
                    # dependency with the module as the alias
                    alias.name == "pipeline"
                    and node.module is not None
                    and node.module.split(".")[-1] == "core"
                ):
                    out.append(Finding(
                        RULE, relpath, node.lineno,
                        f"decode path imports the encode-side pipeline "
                        f"module ({node.module}.{alias.name}); structure "
                        f"must come from the blob's StructuralConfig",
                    ))
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if _is_pipeline_module(alias.name):
                    out.append(Finding(
                        RULE, relpath, node.lineno,
                        f"decode path imports the encode-side pipeline "
                        f"module ({alias.name}); structure must come "
                        f"from the blob's StructuralConfig",
                    ))
        elif isinstance(node, ast.Attribute):
            if (isinstance(node.value, ast.Name)
                    and node.value.id == "os"
                    and node.attr in _ENV_ATTRS):
                out.append(Finding(
                    RULE, relpath, node.lineno,
                    f"decode path reads process environment via "
                    f"os.{node.attr}",
                ))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None
            )
            if (name == "PipelineConfig" and not node.args
                    and not node.keywords):
                out.append(Finding(
                    RULE, relpath, node.lineno,
                    "decode path constructs a default PipelineConfig(); "
                    "config must come from the meta stream",
                ))
    return out
