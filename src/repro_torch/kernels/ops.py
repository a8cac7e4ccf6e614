"""Device dispatch for the hand-written kernels.

A tensor on a CUDA device goes to the hand-written kernel
(:mod:`repro_torch.kernels.gbatc_project`,
:mod:`repro_torch.kernels.flash_attention`) and to nothing else: a build or
launch failure raises, there is no fallback. A tensor on the CPU — which
only happens when the caller asked for ``device="cpu"`` — goes to the plain
version in :mod:`repro_torch.kernels.ref`.

Each op also accepts numpy arrays and a ``device`` argument (``None`` means
the GPU and raises without CUDA, see :mod:`repro_torch.device`): arrays are
staged onto that device first; tensors must already live there.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gbatc_project as _cuda
from repro_torch.kernels import ref as _ref


def _stage(args, device: DeviceLike):
    dev = resolve_device(device)
    out = []
    for a in args:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        elif a.device != dev:
            raise ValueError(f"tensor on {a.device}, but device={dev} was requested")
        out.append(a)
    return dev, out


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
