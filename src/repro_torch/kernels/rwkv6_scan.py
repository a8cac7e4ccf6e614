"""Wrapper of the hand-written CUDA kernel in ``csrc/rwkv6_scan.cu``.

Counterpart of the Pallas function ``rwkv6_scan`` in the JAX package's
``kernels/rwkv6_scan.py``: the WKV6 recurrence over r, k, v, w (B, T, H, N)
and u (H, N), all fp32 or all bf16, with s0 (B, H, N, N) fp32 or None
(zero), w clamped to [1e-37, 1] as the TPU kernel clamps it. Returns (out
(B, T, H, N) in r's dtype, S_T (B, H, N, N) fp32). Any N >= 1 (RWKV-6's
head size is 64; past it the chunked form on the tensor cores, the columns
of S in slabs to separate CTAs, S in registers to N = 1024 and in S_T's
memory past it) and any T; nothing is padded. See
:func:`repro_torch.kernels.ref.rwkv6_scan_ref` for the recurrence and
:mod:`repro_torch.kernels._wrap` for what every wrapper checks and how it
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import INT, PTR, check, cuda_operand, declare, launch, refuse_grad

#: launches since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {"rwkv6_scan": 0}

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [PTR] * 8 + [INT, INT, INT, INT, PTR]
_FUNCS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _lib():
    lib = _build.load()["rwkv6_scan"]
    if not _FUNCS:
        _FUNCS.update(declare(lib, "rwkv6_error_string", {
            dtype: (f"rwkv6_scan_{suffix}", _ARGTYPES)
            for dtype, suffix in _DTYPES.items()}))
    return lib


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch: (out, S_T); see the module docstring."""
    refuse_grad("rwkv6_scan", r, k, v, w, u, s0)
    if not isinstance(r, torch.Tensor) or r.dim() != 4:
        raise ValueError("r must be a (B, T, H, N) tensor")
    b, t, h, n = r.shape
    if n < 1:
        raise ValueError(f"head size N={n}: the kernel takes N >= 1")
    cuda_operand("r", r, _DTYPES)
    dt, dev = r.dtype, r.device
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        check(name, x, (b, t, h, n), dt, dev)
    check("u", u, (h, n), dt, dev)
    if s0 is not None:
        check("s0", s0, (b, h, n, n), torch.float32, dev)
    out = torch.empty_like(r)
    s_last = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    if s_last.numel():
        lib = _lib()
        launch("rwkv6_scan", _FUNCS[dt],
               (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), 0 if s0 is None else s0.data_ptr(),
                out.data_ptr(), s_last.data_ptr(), b, t, h, n),
               dev, lib.rwkv6_error_string)
        LAUNCHES["rwkv6_scan"] += 1
    return out, s_last
