"""Wrapper of the hand-written CUDA kernel in ``csrc/flash_attention.cu``.

Counterpart of the Pallas function ``flash_attention`` in the JAX package's
``kernels/flash_attention.py``, with the same public layout: q (B, H, Tq,
D), k and v (B, H, Tk, D), contiguous, fp32 or bf16, any D >= 1 and any
Tq. Unlike the Pallas wrapper it takes any Tk, causal or not (the kernel
masks the ragged key tail itself), and it pads nothing in device memory.
fp32 runs on the CUDA cores up to D = 32 (the codec's D = 16 keeps its
bits) and on the tensor cores past it, every product in 3xTF32 (each
operand split into two TF32 parts, three products); bf16 runs on the
tensor cores at every D (fp32 scores and softmax, P V as a bf16 hi/lo
pair). Past D = 256 both dtypes run one kernel, ``flash_wide_mma``, whose
CTAs stream Q, K and V through shared memory and compute a row's scores
once for every 512 of its output columns. The source describes all four
kernels.

The kernel has no backward: a call that would need a gradient raises (the
attention family trains through its direct attention). See
:mod:`repro_torch.kernels._wrap` for what every wrapper checks and how it
launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import (FLOAT, INT, LL, PTR, check, cuda_operand, declare,
                                       launch, refuse_grad)

#: launches since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {"flash_attention": 0}

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [PTR] * 4 + [LL, INT, INT, INT, INT, INT, FLOAT, PTR]
_FUNCS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _lib():
    """The loaded kernel library, with every function's C signature
    declared (built at the first call)."""
    lib = _build.load()["flash_attention"]
    if not _FUNCS:
        _FUNCS.update(declare(lib, "flash_error_string", {
            dtype: (f"flash_attention_{suffix}", _ARGTYPES)
            for dtype, suffix in _DTYPES.items()}))
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D) + mask) v`` in one launch; see the module
    docstring for what it takes."""
    refuse_grad("flash_attention", q, k, v)
    if isinstance(q, torch.Tensor) and q.dim() == 4 and q.shape[3] < 1:
        raise ValueError(f"head dim D={q.shape[3]}: the kernel takes D >= 1")
    cuda_operand("q", q, _DTYPES)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, Tq, D), got shape {tuple(q.shape)}")
    b, h, tq, d = q.shape
    if not isinstance(k, torch.Tensor) or k.dim() != 4:
        raise ValueError("k must be a (B, H, Tk, D) tensor")
    tk = k.shape[2]
    check("q", q, (b, h, tq, d), q.dtype, q.device)
    check("k", k, (b, h, tk, d), q.dtype, q.device)
    check("v", v, (b, h, tk, d), q.dtype, q.device)
    if tk < 1:
        raise ValueError("k and v need at least one key")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty_like(q)
    if out.numel():
        lib = _lib()
        launch("flash_attention", _FUNCS[q.dtype],
               (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, tq, tk, d, int(causal), int(window), 1.0 / math.sqrt(d)),
               q.device, lib.flash_error_string)
        LAUNCHES["flash_attention"] += 1
    return out
