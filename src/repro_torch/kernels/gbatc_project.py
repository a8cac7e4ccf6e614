"""Wrappers of the hand-written CUDA kernels in ``csrc/gbatc_kernels.cu``.

Counterparts of the Pallas functions ``gbatc_project_batched``,
``gbatc_correct_batched`` and ``gbatc_select_accumulate`` in the JAX
package's ``kernels/gbatc_project.py``. Each wrapper checks device, dtype,
shape and contiguity and raises on what the kernel does not take,
allocates its output with ``torch.empty``, launches on PyTorch's current
stream without synchronising, checks the launch's error code, and adds one
to its entry in :data:`LAUNCHES` where — and only where — it launches.

These functions take CUDA tensors only; CPU tensors go through
:mod:`repro_torch.kernels.ops`, which dispatches on the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {
    "gbatc_project_batched": 0,
    "gbatc_select_accumulate": 0,
    "gbatc_correct_batched": 0,
}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_TILES_PER_CTA = 8  # row tiles one CTA walks with its basis resident: short
# runs keep the grid many waves deep, so no SM idles through a long tail
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "gbatc_project_batched": [_PTR] * 3 + [_INT, _LL, _INT, _INT, _PTR],
    "gbatc_correct_batched": [_PTR] * 4 + [_INT, _LL, _INT, _INT, _PTR],
    "gbatc_select_accumulate": [_PTR] * 6 + [_INT, _LL, _INT, _INT, _PTR],
}
_FUNCS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _lib() -> ctypes.CDLL:
    """The loaded kernel library, with every function's C signature
    declared (built at the first call)."""
    lib = _build.load()["gbatc_kernels"]
    if not _FUNCS:
        lib.gbatc_error_string.restype = ctypes.c_char_p
        lib.gbatc_error_string.argtypes = [ctypes.c_int]
        lib.gbatc_max_d.restype = ctypes.c_int
        lib.gbatc_max_d.argtypes = []
        for name, argtypes in _ARGTYPES.items():
            for dtype, suffix in _SUFFIX.items():
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                _FUNCS[name, dtype] = fn
    return lib


def _func(name: str, dtype: torch.dtype):
    _lib()
    return _FUNCS[name, dtype]


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lead(name: str, t: torch.Tensor):
    """Validate the leading (S, NB, D) operand; returns (s, nb, d)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(
            f"{name} is on {t.device}: the CUDA kernels take CUDA tensors only "
            "(repro_torch.kernels.ops dispatches CPU tensors to the plain versions)"
        )
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name} has dtype {t.dtype}; kernels take float32 or float64")
    if t.dim() != 3:
        raise ValueError(f"{name} must be (S, NB, D), got shape {tuple(t.shape)}")
    s, nb, d = t.shape
    max_d = _lib().gbatc_max_d()
    if not 1 <= d <= max_d:
        raise ValueError(f"block size D={d} outside the kernels' range 1..{max_d}")
    return s, nb, d


def _launch(name: str, dtype, device, ptr_args, s: int, nb: int, d: int) -> None:
    fn = _func(name, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*ptr_args, s, nb, d, _TILES_PER_CTA, stream)
    if code != 0:
        msg = _lib().gbatc_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")
    LAUNCHES[name] += 1


def gbatc_project_batched(residual: torch.Tensor,
                          basis: torch.Tensor) -> torch.Tensor:
    """Per-species ``C_s = R_s @ U_s`` in one launch; fp32 or fp64."""
    s, nb, d = _lead("residual", residual)
    _check("residual", residual, (s, nb, d), residual.dtype, residual.device)
    _check("basis", basis, (s, d, d), residual.dtype, residual.device)
    out = torch.empty_like(residual)
    if out.numel():
        _launch("gbatc_project_batched", residual.dtype, residual.device,
                (residual.data_ptr(), basis.data_ptr(), out.data_ptr()),
                s, nb, d)
    return out


def gbatc_correct_batched(x_rec: torch.Tensor, coeffs: torch.Tensor,
                          basis: torch.Tensor) -> torch.Tensor:
    """Per-species ``x_s + C_s @ U_s^T`` in one launch (decode replay)."""
    s, nb, d = _lead("x_rec", x_rec)
    dt, dev = x_rec.dtype, x_rec.device
    _check("x_rec", x_rec, (s, nb, d), dt, dev)
    _check("coeffs", coeffs, (s, nb, d), dt, dev)
    _check("basis", basis, (s, d, d), dt, dev)
    out = torch.empty_like(x_rec)
    if out.numel():
        _launch("gbatc_correct_batched", dt, dev,
                (x_rec.data_ptr(), coeffs.data_ptr(), basis.data_ptr(),
                 out.data_ptr()), s, nb, d)
    return out


def gbatc_select_accumulate(x_rec: torch.Tensor, coeff_vals: torch.Tensor,
                            rank: torch.Tensor, m: torch.Tensor,
                            basis: torch.Tensor) -> torch.Tensor:
    """Fused Algorithm-1 tail ``x + (c . [rank < m]) @ U_s^T``; the keep
    mask exists only in registers."""
    s, nb, d = _lead("x_rec", x_rec)
    dt, dev = x_rec.dtype, x_rec.device
    _check("x_rec", x_rec, (s, nb, d), dt, dev)
    _check("coeff_vals", coeff_vals, (s, nb, d), dt, dev)
    _check("rank", rank, (s, nb, d), torch.int32, dev)
    _check("m", m, (s, nb), torch.int32, dev)
    _check("basis", basis, (s, d, d), dt, dev)
    out = torch.empty_like(x_rec)
    if out.numel():
        _launch("gbatc_select_accumulate", dt, dev,
                (x_rec.data_ptr(), coeff_vals.data_ptr(), rank.data_ptr(),
                 m.data_ptr(), basis.data_ptr(), out.data_ptr()), s, nb, d)
    return out
