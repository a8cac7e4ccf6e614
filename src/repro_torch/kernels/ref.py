"""Plain PyTorch versions of the CUDA kernels in ``csrc/``.

Each is the oracle its kernel is held against on the card, and what
:mod:`repro_torch.kernels.ops` runs for tensors that live on the CPU.
Nothing on the main path calls them when the device is CUDA.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D) + mask) v`` with fp32 scores; q (B, H, Tq,
    D), k and v (B, H, Tk, D) (heads already expanded); returns (B, H, Tq,
    D) in q's dtype. Masked scores are filled with ``-1e30``. Any Tk works,
    causal or not."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def gbatc_project_batched_ref(residual: torch.Tensor,
                              basis: torch.Tensor) -> torch.Tensor:
    """Per-species ``C_s = R_s @ U_s``; (S, NB, D) x (S, D, D) -> (S, NB, D)."""
    return torch.matmul(residual, basis)


def gbatc_correct_batched_ref(x_rec: torch.Tensor, coeffs: torch.Tensor,
                              basis: torch.Tensor) -> torch.Tensor:
    """Per-species ``x_s + C_s @ U_s^T`` (coefficients already masked)."""
    return x_rec + torch.matmul(coeffs, basis.transpose(1, 2))


def gbatc_select_accumulate_ref(x_rec: torch.Tensor, coeff_vals: torch.Tensor,
                                rank: torch.Tensor, m: torch.Tensor,
                                basis: torch.Tensor) -> torch.Tensor:
    """``x + (c . [rank < m[..., None]]) @ U_s^T`` with the mask as a
    ``where`` (never a stored 0/1 tensor on the kernel side)."""
    kept = torch.where(rank < m[..., None], coeff_vals,
                       torch.zeros((), dtype=coeff_vals.dtype,
                                   device=coeff_vals.device))
    return x_rec + torch.matmul(kept, basis.transpose(1, 2))
