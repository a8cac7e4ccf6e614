"""wire-centralization: byte layouts live in format.py / container.py.

Every on-disk byte layout of the GBATC container belongs in
``codec/format.py`` (stream formats) or ``core/container.py`` (outer
framing). A ``struct.pack`` or a 4-byte magic literal anywhere else is a
second, uncoordinated wire site — exactly the kind that
:mod:`repro_torch.analysis.wire_schema` cannot conformance-check and that
drifts silently on the next format bump.

Flags, everywhere outside the two wire modules:

* calls into :mod:`struct` (``pack``/``unpack``/``unpack_from``/
  ``iter_unpack``/``calcsize``/``Struct``) — referencing
  ``struct.error`` in an ``except`` clause is fine and not flagged;
* 4-byte uppercase ASCII bytes literals shaped like stream magics
  (``b"GBTC"``, ``b"LAT3"``, ...).

Deliberate secondary wire owners (e.g. the Huffman stream format in
``core/entropy.py``) carry ``# repro: allow-file[wire-centralization]``
with a comment saying why.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.findings import Finding

RULE = "wire-centralization"

#: The only modules allowed to speak wire bytes.
WIRE_MODULES = frozenset({"codec/format.py", "core/container.py"})

_STRUCT_CALLS = frozenset({
    "pack", "pack_into", "unpack", "unpack_from", "iter_unpack",
    "calcsize", "Struct",
})
_MAGIC = re.compile(rb"^[A-Z][A-Z0-9]{3}$")


def check_file(relpath: str, tree: ast.AST, source: str) -> list[Finding]:
    if relpath in WIRE_MODULES:
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "struct"
                    and fn.attr in _STRUCT_CALLS):
                out.append(Finding(
                    RULE, relpath, node.lineno,
                    f"struct.{fn.attr} outside the wire modules "
                    f"(codec/format.py, core/container.py)",
                ))
        elif isinstance(node, ast.Constant) and isinstance(node.value, bytes):
            if _MAGIC.match(node.value):
                out.append(Finding(
                    RULE, relpath, node.lineno,
                    f"magic-shaped bytes literal {node.value!r} outside "
                    f"the wire modules",
                ))
    return out
