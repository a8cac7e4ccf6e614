"""CPU guard between the CUDA sources under ``kernels/csrc/`` and their
``ctypes`` wrappers.

No ``nvcc`` is needed: each wrapper's ``_lib()`` runs against a stand-in
library that records what the wrapper declares (symbol, argument types,
return type), and the declarations are held against the ``extern "C"``
block of the source the wrapper loads, read as text. A mismatch here would
otherwise show only on the card, as a crash or a wrong argument. Likewise
every kernel a source defines must have a pattern in
``chip_smoke.PTXAS_NAMES``, or its registers and spill drop out of the
card's build report unseen.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import re
from pathlib import Path

import pytest

from repro_torch.kernels import _build

CSRC = Path(_build.__file__).resolve().parent / "csrc"
WRAPPERS = ("gbatc_project", "flash_attention", "block_quant", "rglru_scan",
            "rwkv6_scan")


def _extern_c(stem: str) -> dict[str, tuple[str, list[str]]]:
    """{name: (return type, [parameter type, ...])} of the functions
    defined in the source's ``extern "C"`` block."""
    text = (CSRC / f"{stem}.cu").read_text()
    start = text.index('extern "C" {')
    block = text[start + len('extern "C" {'):text.index('}  // extern "C"', start)]
    funcs = {}
    for ret, name, params in re.findall(
            r"^([A-Za-z_][\w \*]*?)\s*\b([A-Za-z_]\w*)\s*\(([^()]*)\)\s*\{",
            block, flags=re.M):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            if p and p != "void":
                types.append(re.sub(r"\s*\b\w+$", "", p))  # drop the name
        funcs[name] = (" ".join(ret.split()), types)
    return funcs


def _ctype_of(c_type: str):
    if "*" in c_type:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[c_type]


def _restype_of(c_type: str):
    return ctypes.c_char_p if c_type == "const char*" else _ctype_of(c_type)


class _Recorder:
    """Stands in for a loaded ``ctypes.CDLL``: every attribute is a
    function object whose ``argtypes`` / ``restype`` the wrapper sets."""

    def __init__(self):
        self.funcs: dict[str, object] = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.funcs.setdefault(name, type("Fn", (), {})())


def _declared(monkeypatch, module_name: str) -> tuple[str, dict]:
    """(source stem, {symbol: function record}) of what the wrapper
    declares when it loads its library."""
    mod = importlib.import_module(f"repro_torch.kernels.{module_name}")
    recorder, stems = _Recorder(), []

    class _Libs(dict):
        def __getitem__(self, stem):
            stems.append(stem)
            return recorder

    monkeypatch.setattr(_build, "load", lambda: _Libs())
    monkeypatch.setattr(mod, "_FUNCS", {})
    mod._lib()
    assert len(set(stems)) == 1, stems
    return stems[0], recorder.funcs


@pytest.mark.parametrize("module_name", WRAPPERS)
def test_wrapper_declarations_match_the_source(monkeypatch, module_name):
    stem, funcs = _declared(monkeypatch, module_name)
    exported = _extern_c(stem)
    assert funcs, f"{module_name} declared nothing"
    for symbol, fn in funcs.items():
        assert symbol in exported, f"{symbol} is not in {stem}.cu's extern \"C\" block"
        ret, params = exported[symbol]
        argtypes = getattr(fn, "argtypes", None)
        assert argtypes is not None, f"{symbol}: argtypes never declared"
        assert len(argtypes) == len(params), (
            f"{symbol}: wrapper passes {len(argtypes)} arguments, "
            f"{stem}.cu takes {len(params)}")
        assert list(argtypes) == [_ctype_of(p) for p in params], (symbol, params)
        assert getattr(fn, "restype", None) == _restype_of(ret), (symbol, ret)


@pytest.mark.parametrize("module_name", WRAPPERS)
def test_every_exported_function_is_declared(monkeypatch, module_name):
    stem, funcs = _declared(monkeypatch, module_name)
    assert sorted(funcs) == sorted(_extern_c(stem))


def test_build_sources_are_the_sources_on_disk():
    assert sorted(_build.SOURCES) == sorted(p.name for p in CSRC.glob("*.cu"))


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cu")))
def test_source_has_a_plain_c_interface(source):
    includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)[>\"]",
                          (CSRC / source).read_text(), flags=re.M)
    assert includes, source
    assert not [i for i in includes if i.startswith(("torch/", "ATen/", "c10/"))]
    assert "torch/extension.h" not in includes


def _chip_smoke():
    """``chip_smoke.py`` at the checkout root, imported by path (its top
    level needs nothing but the standard library)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_names(source: str) -> list[str]:
    """Names of the ``__global__`` functions the source defines."""
    text = (CSRC / source).read_text()
    return re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\s*\([^()]*\)\s*)?(\w+)\s*\(", text)


def _names_kernel(pattern: str, name: str) -> bool:
    """``pattern`` (a mangled name without its length prefix) is for the
    kernel ``name``, not for a longer name that starts with it."""
    return re.match(re.escape(name) + r"(?![a-z0-9_])", pattern) is not None


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cu")))
def test_every_kernel_has_a_ptxas_pattern(source):
    patterns = [p for p, _ in _chip_smoke().PTXAS_NAMES.get(source[:-3], [])]
    kernels = _kernel_names(source)
    assert kernels, f"no __global__ kernel found in {source}"
    for name in kernels:
        assert any(_names_kernel(p, name) for p in patterns), (
            f"{source}: kernel {name} has no pattern in chip_smoke.PTXAS_NAMES")


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cu")))
def test_every_ptxas_pattern_names_a_kernel(source):
    kernels = _kernel_names(source)
    for pattern, _ in _chip_smoke().PTXAS_NAMES.get(source[:-3], []):
        re.compile(pattern)
        assert any(_names_kernel(pattern, k) for k in kernels), (
            f"chip_smoke.PTXAS_NAMES pattern {pattern!r} names no kernel of {source}")


def test_ptxas_names_cover_every_source():
    assert sorted(_chip_smoke().PTXAS_NAMES) == sorted(
        Path(p).stem for p in _build.SOURCES)


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cu")))
def test_no_launcher_refuses_a_grid_past_65535(source):
    """A grid's y (and z) stops at 65,535; the reference has no such limit.
    Every 65535 in the code is a clamp of a grid dimension (``n < 65535 ? n
    : 65535``) and no launcher compares a count against it to refuse; a
    source that clamps walks the rest with grid-stride loops over y."""
    code = re.sub(r"//[^\n]*", "", (CSRC / source).read_text())
    for m in re.finditer(r"6553[56]", code):
        line = code[code.rfind("\n", 0, m.start()) + 1:code.find("\n", m.end())]
        assert re.search(r"(\w+) < 65535 \? \1 : 65535", line), (
            f"{source}: 65535 outside a grid clamp: {line.strip()!r}")
    if "65535 ?" in code:
        assert "+= gridDim.y" in code, f"{source} clamps a grid but never loops over y"
