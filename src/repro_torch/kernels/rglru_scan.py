"""Wrapper of the hand-written CUDA kernel in ``csrc/rglru_scan.cu``.

Counterpart of the Pallas function ``rglru_scan`` in the JAX package's
``kernels/rglru_scan.py``: ``h_t = a_t * h_{t-1} + b_t`` per channel, a
clamped to [1e-37, 1] as the TPU kernel clamps it; a and b (B, T, W) fp32
or bf16 of one dtype, h0 (B, W) fp32 or None (zero). Returns (h (B, T, W)
in a's dtype, h_T (B, W) fp32). Any T and W; nothing is padded. Its bits
equal :func:`repro_torch.kernels.ref.rglru_scan_ref`'s. See
:mod:`repro_torch.kernels._wrap` for what every wrapper checks and how it
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import INT, PTR, check, cuda_operand, declare, launch, refuse_grad

#: launches since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {"rglru_scan": 0}

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [PTR] * 5 + [INT, INT, INT, PTR]
_FUNCS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _lib():
    lib = _build.load()["rglru_scan"]
    if not _FUNCS:
        _FUNCS.update(declare(lib, "rglru_error_string", {
            dtype: (f"rglru_scan_{suffix}", _ARGTYPES)
            for dtype, suffix in _DTYPES.items()}))
    return lib


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch: (h, h_T); see the module docstring."""
    refuse_grad("rglru_scan", a, b, h0)
    cuda_operand("a", a, _DTYPES)
    if a.dim() != 3:
        raise ValueError(f"a must be (B, T, W), got shape {tuple(a.shape)}")
    bb, t, w = a.shape
    check("a", a, (bb, t, w), a.dtype, a.device)
    check("b", b, (bb, t, w), a.dtype, a.device)
    if h0 is not None:
        check("h0", h0, (bb, w), torch.float32, a.device)
    h = torch.empty_like(a)
    h_last = torch.empty((bb, w), dtype=torch.float32, device=a.device)
    if h_last.numel():
        lib = _lib()
        launch("rglru_scan", _FUNCS[a.dtype],
               (a.data_ptr(), b.data_ptr(), 0 if h0 is None else h0.data_ptr(),
                h.data_ptr(), h_last.data_ptr(), bb, t, w),
               a.device, lib.rglru_error_string)
        LAUNCHES["rglru_scan"] += 1
    return h, h_last
