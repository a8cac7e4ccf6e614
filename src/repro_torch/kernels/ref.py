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


def gbatc_project_ref(residual: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Single-species ``C = R @ U``; (NB, D) x (D, D) -> (NB, D) in the
    operands' promoted dtype (as the Pallas kernel's ``jnp.result_type``)."""
    dtype = torch.promote_types(residual.dtype, basis.dtype)
    return residual.to(dtype) @ basis.to(dtype)


def gbatc_correct_ref(x_rec: torch.Tensor, coeffs: torch.Tensor,
                      mask: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Single-species ``x + (c * mask) @ U^T``, mask converted to the
    operands' promoted dtype (0/1 keep mask, any dtype)."""
    dtype = torch.promote_types(torch.promote_types(x_rec.dtype, coeffs.dtype),
                                basis.dtype)
    kept = coeffs.to(dtype) * mask.to(dtype)
    return x_rec.to(dtype) + kept @ basis.to(dtype).T


def block_quant_ref(x: torch.Tensor, n_bits: int = 8,
                    block: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-``block`` symmetric quantise -> dequantise along the last axis, in
    fp32; returns (dequantised x in x's dtype, fp32 scales (..., K/block)).

    Both divisions are IEEE divisions by tensors: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which moves a scale by
    an ulp (as XLA's rewrite does in the reference's compiled kernel)."""
    *lead, kdim = x.shape
    if block < 1 or kdim % block:
        raise ValueError(f"last axis K={kdim} is not a multiple of block={block}")
    xb = x.reshape(*lead, kdim // block, block).float()
    qmax = float(2 ** (n_bits - 1) - 1)
    qmax_t = torch.tensor(qmax, dtype=torch.float32, device=x.device)
    scale = torch.clamp(xb.abs().amax(-1, keepdim=True), min=1e-30) / qmax_t
    q = torch.clamp(torch.round(xb / scale), -qmax - 1, qmax)
    out = (q * scale).reshape(x.shape).to(x.dtype)
    return out, scale[..., 0]


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + b_t`` per channel in fp32, a clamped to [1e-37,
    1] as the TPU kernel clamps it before its logs; a, b (B, T, W), h0 (B,
    W). Returns (h (B, T, W) in a's dtype, h_T (B, W) fp32)."""
    bb, t, w = a.shape
    af = torch.clamp(a.float(), 1e-37, 1.0)
    bf = b.float()
    h = (torch.zeros((bb, w), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = torch.empty((bb, t, w), dtype=a.dtype, device=a.device)
    for i in range(t):
        h = af[:, i] * h + bf[:, i]
        out[:, i] = h
    return out, h


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   s0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV6 recurrence in fp32, w clamped to [1e-37, 1] as the TPU kernel
    clamps it: r, k, v, w (B, T, H, N), u (H, N), s0 (B, H, N, N) with rows
    i over r/k/w and columns j over v.
    ``out_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j])``, then
    ``S[i, j] = w_t[i] S[i, j] + k_t[i] v_t[j]``. Returns (out (B, T, H, N)
    in r's dtype, S_T (B, H, N, N) fp32)."""
    b, t, h, n = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.clamp(w.float(), 1e-37, 1.0)
    uf = u.float()[None, :, :, None]
    s = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    out = torch.empty((b, t, h, n), dtype=r.dtype, device=r.device)
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]
        out[:, i] = torch.einsum("bhi,bhij->bhj", rf[:, i], s + uf * kv)
        s = wf[:, i, :, :, None] * s + kv
    return out, s
