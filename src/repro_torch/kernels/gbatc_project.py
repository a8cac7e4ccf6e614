"""Wrappers of the hand-written CUDA kernels in ``csrc/gbatc_kernels.cu``.

Counterparts of the Pallas functions ``gbatc_project_batched``,
``gbatc_correct_batched``, ``gbatc_select_accumulate`` and the 2D
single-species pair ``gbatc_project`` / ``gbatc_correct`` in the JAX
package's ``kernels/gbatc_project.py``. Every route takes any block size
D >= 1, as the Pallas wrappers do by padding. The kernel a launch runs
depends on D (``csrc/gbatc_kernels.cu``):

* D <= 128 keeps a species' (D, D) basis in shared memory: the fp64
  projection on the fp64 tensor cores (``project_f64_dmma``), the fp32
  projection as 3xTF32 (``project_f32_3xtf32``), fp32 select and correct
  on a cp.async ring (``correct_f32_ring``), and the fp64 select and
  correct and the masked 2D correct on ``gbatc_tile_kernel``;
* past 128 the basis is staged in k panels, every route on the tensor
  cores: the fp64 projection in 256-column slabs (``project_f64_wide``),
  every fp32 route (the projection, select, correct and the masked 2D
  correct) as 3xTF32 (``gbatc_wide_3xtf32``: each operand split once, as
  it is staged, into tf32 hi and lo planes in fragment order; a k pair's
  three products summed from +0 and then added to the accumulator), and
  the fp64 select, correct and masked correct on DMMA
  (``gbatc_wide_dmma``). Both work 128-row tiles against slabs of up to
  128 columns, a producer warpgroup copying and preparing each k panel
  ahead of 8 MMA warps. Select stays bitwise correct on ``where(rank < m,
  c, 0)`` in both dtypes.

See :mod:`repro_torch.kernels._wrap` for what every wrapper checks and how
it launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import (INT, LL, PTR, check, cuda_operand, declare, launch,
                                       refuse_grad)

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {
    "gbatc_project_batched": 0,
    "gbatc_select_accumulate": 0,
    "gbatc_correct_batched": 0,
    "gbatc_project": 0,
    "gbatc_correct": 0,
}

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_TILES_PER_CTA = 8  # row tiles one CTA walks with its basis resident: short
# runs keep the grid many waves deep, so no SM idles through a long tail
_ARGTYPES = {
    "gbatc_project_batched": [PTR] * 3 + [INT, LL, INT, INT, PTR],
    "gbatc_correct_batched": [PTR] * 4 + [INT, LL, INT, INT, PTR],
    "gbatc_select_accumulate": [PTR] * 6 + [INT, LL, INT, INT, PTR],
    "gbatc_correct_masked": [PTR] * 5 + [INT, LL, INT, INT, PTR],
}
_FUNCS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _lib():
    """The loaded kernel library, with every function's C signature
    declared (built at the first call)."""
    lib = _build.load()["gbatc_kernels"]
    if not _FUNCS:
        _FUNCS.update(declare(lib, "gbatc_error_string", {
            (name, dtype): (f"{name}_{suffix}", argtypes)
            for name, argtypes in _ARGTYPES.items()
            for dtype, suffix in _DTYPES.items()}))
    return lib


def _check_d(d: int) -> None:
    """D >= 1 (checked before the device, so the CPU tests see it too)."""
    if d < 1:
        raise ValueError(f"block size D={d}: the kernels take D >= 1")


def _lead(name: str, t):
    """Validate the leading (S, NB, D) operand; returns (s, nb, d)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dim() != 3:
        raise ValueError(f"{name} must be (S, NB, D), got shape {tuple(t.shape)}")
    s, nb, d = t.shape
    _check_d(d)
    cuda_operand(name, t, _DTYPES)
    return s, nb, d


def _launch(func: str, counter: str, dtype, device, ptr_args, s: int, nb: int,
            d: int) -> None:
    lib = _lib()
    launch(counter, _FUNCS[func, dtype], (*ptr_args, s, nb, d, _TILES_PER_CTA),
           device, lib.gbatc_error_string)
    LAUNCHES[counter] += 1


def gbatc_project_batched(residual: torch.Tensor,
                          basis: torch.Tensor) -> torch.Tensor:
    """Per-species ``C_s = R_s @ U_s`` in one launch; fp32 or fp64."""
    refuse_grad("gbatc_project_batched", residual, basis)
    s, nb, d = _lead("residual", residual)
    check("residual", residual, (s, nb, d), residual.dtype, residual.device)
    check("basis", basis, (s, d, d), residual.dtype, residual.device)
    out = torch.empty_like(residual)
    if out.numel():
        _launch("gbatc_project_batched", "gbatc_project_batched", residual.dtype,
                residual.device,
                (residual.data_ptr(), basis.data_ptr(), out.data_ptr()), s, nb, d)
    return out


def gbatc_correct_batched(x_rec: torch.Tensor, coeffs: torch.Tensor,
                          basis: torch.Tensor) -> torch.Tensor:
    """Per-species ``x_s + C_s @ U_s^T`` in one launch (decode replay)."""
    refuse_grad("gbatc_correct_batched", x_rec, coeffs, basis)
    s, nb, d = _lead("x_rec", x_rec)
    dt, dev = x_rec.dtype, x_rec.device
    check("x_rec", x_rec, (s, nb, d), dt, dev)
    check("coeffs", coeffs, (s, nb, d), dt, dev)
    check("basis", basis, (s, d, d), dt, dev)
    out = torch.empty_like(x_rec)
    if out.numel():
        _launch("gbatc_correct_batched", "gbatc_correct_batched", dt, dev,
                (x_rec.data_ptr(), coeffs.data_ptr(), basis.data_ptr(),
                 out.data_ptr()), s, nb, d)
    return out


def gbatc_select_accumulate(x_rec: torch.Tensor, coeff_vals: torch.Tensor,
                            rank: torch.Tensor, m: torch.Tensor,
                            basis: torch.Tensor) -> torch.Tensor:
    """Fused Algorithm-1 tail ``x + (c . [rank < m]) @ U_s^T``; the keep
    mask exists only in registers."""
    refuse_grad("gbatc_select_accumulate", x_rec, coeff_vals, basis)
    s, nb, d = _lead("x_rec", x_rec)
    dt, dev = x_rec.dtype, x_rec.device
    check("x_rec", x_rec, (s, nb, d), dt, dev)
    check("coeff_vals", coeff_vals, (s, nb, d), dt, dev)
    check("rank", rank, (s, nb, d), torch.int32, dev)
    check("m", m, (s, nb), torch.int32, dev)
    check("basis", basis, (s, d, d), dt, dev)
    out = torch.empty_like(x_rec)
    if out.numel():
        _launch("gbatc_select_accumulate", "gbatc_select_accumulate", dt, dev,
                (x_rec.data_ptr(), coeff_vals.data_ptr(), rank.data_ptr(),
                 m.data_ptr(), basis.data_ptr(), out.data_ptr()), s, nb, d)
    return out


def _two_d(name: str, t) -> tuple[int, int]:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be (NB, D), got shape {tuple(t.shape)}")
    _check_d(t.shape[1])
    return t.shape


def _promoted(*tensors) -> torch.dtype:
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def gbatc_project(residual: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Single-species ``C = R @ U``; residual (NB, D), basis (D, D).

    Computes in the operands' promoted dtype (fp32 or fp64, as the Pallas
    kernel's ``jnp.result_type``; an operand of another dtype is converted
    first). The launch is the batched projection kernel on (1, NB, D) and
    (1, D, D) views: nothing is copied or padded."""
    refuse_grad("gbatc_project", residual, basis)
    nb, d = _two_d("residual", residual)
    dtype = _promoted(residual, basis)
    residual, basis = residual.to(dtype), basis.to(dtype)
    cuda_operand("residual", residual, _DTYPES)
    check("residual", residual, (nb, d), dtype, residual.device)
    check("basis", basis, (d, d), dtype, residual.device)
    out = torch.empty_like(residual)
    if out.numel():
        _launch("gbatc_project_batched", "gbatc_project", dtype, residual.device,
                (residual.data_ptr(), basis.data_ptr(), out.data_ptr()), 1, nb, d)
    return out


def gbatc_correct(x_rec: torch.Tensor, coeffs: torch.Tensor, mask: torch.Tensor,
                  basis: torch.Tensor) -> torch.Tensor:
    """Single-species ``x + (c * mask) @ U^T``; x_rec, coeffs, mask (NB, D),
    basis (D, D).

    Computes in the promoted dtype of x_rec, coeffs and basis (fp32 or
    fp64). The mask (bool, int or float 0/1) is converted to that dtype
    with one ``.to(dtype)``, as the Pallas kernel's ``m_ref[...].astype(
    c_ref.dtype)``; the kernel multiplies it into the coefficients while it
    stages them, so the masked coefficients never reach device memory."""
    refuse_grad("gbatc_correct", x_rec, coeffs, mask, basis)
    nb, d = _two_d("x_rec", x_rec)
    dtype = _promoted(x_rec, coeffs, basis)
    x_rec, coeffs, basis = x_rec.to(dtype), coeffs.to(dtype), basis.to(dtype)
    if not isinstance(mask, torch.Tensor):
        raise TypeError(f"mask must be a torch.Tensor, got {type(mask).__name__}")
    mask = mask.to(dtype)
    cuda_operand("x_rec", x_rec, _DTYPES)
    dev = x_rec.device
    check("x_rec", x_rec, (nb, d), dtype, dev)
    check("coeffs", coeffs, (nb, d), dtype, dev)
    check("mask", mask, (nb, d), dtype, dev)
    check("basis", basis, (d, d), dtype, dev)
    out = torch.empty_like(x_rec)
    if out.numel():
        _launch("gbatc_correct_masked", "gbatc_correct", dtype, dev,
                (x_rec.data_ptr(), coeffs.data_ptr(), mask.data_ptr(),
                 basis.data_ptr(), out.data_ptr()), 1, nb, d)
    return out
