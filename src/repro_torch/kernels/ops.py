"""Device dispatch for the hand-written kernels; the port's kernel-ops entry
point.

A tensor on a CUDA device goes to the hand-written kernel
(:mod:`repro_torch.kernels.gbatc_project`,
:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.block_quant`,
:mod:`repro_torch.kernels.rglru_scan`,
:mod:`repro_torch.kernels.rwkv6_scan`) and to nothing else: a build or
launch failure raises, there is no fallback. A tensor on the CPU — which
only happens when the caller asked for ``device="cpu"`` — goes to the plain
version in :mod:`repro_torch.kernels.ref`.

Each op also accepts numpy arrays and a ``device`` argument (``None`` means
the GPU and raises without CUDA, see :mod:`repro_torch.device`): arrays are
staged onto that device first; tensors must already live there.

The ``*_op`` functions are the counterparts of the JAX package's
``kernels/ops.py``, with its names and keywords. Their tiling keywords
(``chunk``, ``block_w``, ``rows_per_tile``, ``block_q``, ``block_k``) are
the TPU kernels' tile sizes: they are checked to be positive ints and
change nothing here, since the CUDA kernels pick their own tiling and pad
nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import block_quant as _bq
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gbatc_project as _cuda
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import rwkv6_scan as _rwkv6


def _stage(args, device: DeviceLike):
    """Resolve ``device`` and put every array there (``None`` stays None)."""
    dev = resolve_device(device)
    out = []
    for a in args:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        elif a is not None and a.device != dev:
            raise ValueError(f"tensor on {a.device}, but device={dev} was requested")
        out.append(a)
    return dev, out


def _tile_sizes(**sizes) -> None:
    for name, value in sizes.items():
        if isinstance(value, bool) or not isinstance(value, int) or value < 1:
            raise ValueError(f"{name} must be a positive int, got {value!r}")


def gbatc_project_batched(residual, basis, *, device: DeviceLike = None):
    dev, (residual, basis) = _stage((residual, basis), device)
    if dev.type == "cuda":
        return _cuda.gbatc_project_batched(residual, basis)
    return _ref.gbatc_project_batched_ref(residual, basis)


def gbatc_correct_batched(x_rec, coeffs, basis, *, device: DeviceLike = None):
    dev, (x_rec, coeffs, basis) = _stage((x_rec, coeffs, basis), device)
    if dev.type == "cuda":
        return _cuda.gbatc_correct_batched(x_rec, coeffs, basis)
    return _ref.gbatc_correct_batched_ref(x_rec, coeffs, basis)


def gbatc_select_accumulate(x_rec, coeff_vals, rank, m, basis, *,
                            device: DeviceLike = None):
    dev, (x_rec, coeff_vals, rank, m, basis) = _stage(
        (x_rec, coeff_vals, rank, m, basis), device)
    if dev.type == "cuda":
        return _cuda.gbatc_select_accumulate(x_rec, coeff_vals, rank, m, basis)
    return _ref.gbatc_select_accumulate_ref(x_rec, coeff_vals, rank, m, basis)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    device: DeviceLike = None):
    """(B, H, Tq, D) attention; see :func:`repro_torch.kernels.ref.flash_attention_ref`."""
    dev, (q, k, v) = _stage((q, k, v), device)
    if dev.type == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)


# -- the JAX package's kernels/ops.py, name for name -----------------------


def flash_attention_op(q, k, v, *, causal=True, window=0, block_q=128,
                       block_k=128, device: DeviceLike = None):
    """Flash attention over q (B, H, Tq, D), k and v (B, H, Tk, D)."""
    _tile_sizes(block_q=block_q, block_k=block_k)
    return flash_attention(q, k, v, causal=causal, window=window, device=device)


def rwkv6_scan_op(r, k, v, w, u, s0=None, *, chunk=32, device: DeviceLike = None):
    """WKV6 recurrence; returns (out (B, T, H, N), S_T (B, H, N, N) fp32)."""
    _tile_sizes(chunk=chunk)
    dev, (r, k, v, w, u, s0) = _stage((r, k, v, w, u, s0), device)
    if dev.type == "cuda":
        return _rwkv6.rwkv6_scan(r, k, v, w, u, s0)
    return _ref.rwkv6_scan_ref(r, k, v, w, u, s0)


def rglru_scan_op(a, b, h0=None, *, chunk=64, block_w=128,
                  device: DeviceLike = None):
    """``h_t = a_t h_{t-1} + b_t``; returns (h (B, T, W), h_T (B, W) fp32)."""
    _tile_sizes(chunk=chunk, block_w=block_w)
    dev, (a, b, h0) = _stage((a, b, h0), device)
    if dev.type == "cuda":
        return _rglru.rglru_scan(a, b, h0)
    return _ref.rglru_scan_ref(a, b, h0)


def block_quant_op(x, *, n_bits=8, block=64, rows_per_tile=256,
                   device: DeviceLike = None):
    """Per-block quantise -> dequantise; returns (x', scales (..., K/block))."""
    _tile_sizes(rows_per_tile=rows_per_tile)
    dev, (x,) = _stage((x,), device)
    _bq.check_args(x, n_bits, block)
    if dev.type == "cuda":
        return _bq.block_quant(x, n_bits=n_bits, block=block)
    return _ref.block_quant_ref(x, n_bits=n_bits, block=block)


def gbatc_project_op(residual, basis, *, rows_per_tile=512,
                     device: DeviceLike = None):
    """Single-species ``C = R @ U``; (NB, D) x (D, D) -> (NB, D)."""
    _tile_sizes(rows_per_tile=rows_per_tile)
    dev, (residual, basis) = _stage((residual, basis), device)
    if dev.type == "cuda":
        return _cuda.gbatc_project(residual, basis)
    return _ref.gbatc_project_ref(residual, basis)


def gbatc_correct_op(x_rec, coeffs, mask, basis, *, rows_per_tile=512,
                     device: DeviceLike = None):
    """Single-species ``x + (c * mask) @ U^T``; (NB, D) operands, (D, D) basis."""
    _tile_sizes(rows_per_tile=rows_per_tile)
    dev, (x_rec, coeffs, mask, basis) = _stage((x_rec, coeffs, mask, basis), device)
    if dev.type == "cuda":
        return _cuda.gbatc_correct(x_rec, coeffs, mask, basis)
    return _ref.gbatc_correct_ref(x_rec, coeffs, mask, basis)
