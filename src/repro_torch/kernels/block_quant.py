"""Wrapper of the hand-written CUDA kernel in ``csrc/block_quant.cu``.

Counterpart of the Pallas function ``block_quant`` in the JAX package's
``kernels/block_quant.py``: per-``block`` symmetric quantise -> dequantise
along the last axis of x (..., K), K % block == 0, fp32 or bf16, fp32
arithmetic; returns (dequantised x in x's dtype, fp32 scales (...,
K/block)). Its bits equal :func:`repro_torch.kernels.ref.block_quant_ref`'s.
See :mod:`repro_torch.kernels._wrap` for what every wrapper checks and how
it launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import (FLOAT, INT, LL, PTR, check, cuda_operand, declare,
                                       launch, refuse_grad)

#: launches since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {"block_quant": 0}

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [PTR] * 3 + [LL, INT, FLOAT, PTR]
_FUNCS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _lib():
    lib = _build.load()["block_quant"]
    if not _FUNCS:
        _FUNCS.update(declare(lib, "block_quant_error_string", {
            dtype: (f"block_quant_{suffix}", _ARGTYPES)
            for dtype, suffix in _DTYPES.items()}))
    return lib


def check_args(x, n_bits: int, block: int) -> None:
    """What both the kernel and its plain version require of the call."""
    if not isinstance(block, int) or block < 1 or x.shape[-1] % block:
        raise ValueError(f"last axis K={x.shape[-1]} is not a multiple of "
                         f"block={block}")
    if not isinstance(n_bits, int) or not 2 <= n_bits <= 24:
        raise ValueError(f"n_bits={n_bits} outside 2..24 (qmax = 2^(n_bits-1) - 1 "
                         "must be a positive integer exact in fp32)")


def block_quant(x: torch.Tensor, *, n_bits: int = 8,
                block: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch: (dequantised x, scales); see the module docstring."""
    refuse_grad("block_quant", x)
    if not isinstance(x, torch.Tensor) or x.dim() < 1:
        raise ValueError("x must be a tensor (..., K)")
    check_args(x, n_bits, block)
    cuda_operand("x", x, _DTYPES)
    check("x", x, x.shape, x.dtype, x.device)
    out = torch.empty_like(x)
    scales = torch.empty(x.shape[:-1] + (x.shape[-1] // block,),
                         dtype=torch.float32, device=x.device)
    if x.numel():
        lib = _lib()
        launch("block_quant", _FUNCS[x.dtype],
               (x.data_ptr(), out.data_ptr(), scales.data_ptr(),
                x.numel() // block, block, float(2 ** (n_bits - 1) - 1)),
               x.device, lib.block_quant_error_string)
        LAUNCHES["block_quant"] += 1
    return out, scales
