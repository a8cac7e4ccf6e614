"""Shared model machinery: fixed sinusoidal positions and attention.

Port of what the attention encoder family needs from the JAX package's
``models/common.py``, in the same (B, T, H, D) layout: the host-side
``sinusoidal_positions`` table (a numpy copy), ``repeat_kv`` and
``attention`` down its direct branch, which every call with ``tq * tk <=
4096**2`` and ``tq <= 4096`` takes. Longer sequences take the reference's
chunked online-softmax branch, which is not ported: they raise
``NotImplementedError``. Rotary embeddings and decode attention are not
ported either.

This is the differentiable attention the family trains through. The
hand-written kernel (:mod:`repro_torch.kernels.flash_attention`) computes
the same function without gradients.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30
_DIRECT_MAX = 4096  # the reference's direct-branch limit on tq (and sqrt(tq*tk))


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / (10000 ** (dim / d))
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, Hkv, D) -> (B, T, Hkv*n_rep, D)."""
    if n_rep == 1:
        return x
    b, t, h, d = x.shape
    return x[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(b, t, h * n_rep, d)


def _direct_attention(q, k, v, *, causal, window, q_offset):
    tq, d = q.shape[1], q.shape[3]
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    qpos = q_offset + torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              q_offset: int = 0) -> torch.Tensor:
    """GQA attention; q (B, Tq, H, D), k and v (B, Tk, Hkv, D)."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    tq, tk = q.shape[1], k.shape[1]
    if tq * tk <= _DIRECT_MAX * _DIRECT_MAX and tq <= _DIRECT_MAX:
        return _direct_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    raise NotImplementedError(
        f"attention over tq={tq}, tk={tk} needs the reference's chunked "
        "branch, which is not ported"
    )
