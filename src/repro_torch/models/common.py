"""Shared model machinery: rotary embeddings (standard / partial / M-RoPE),
attention (direct, chunked online-softmax, and the flash kernel route),
decode attention against a KV cache, and small helpers.

Port of the JAX package's ``models/common.py`` in the same (B, T, H, D)
layout. :func:`attention` is the reference's on every length: its direct
branch for ``tq * tk <= 4096**2`` and ``tq <= 4096``, else the chunked
online-softmax branch (loops over q and k chunks where the reference scans).
With ``use_kernels=True`` it is the flash route instead: KV heads repeated,
(B, H, T, D) made contiguous, one launch of the hand-written kernel
(:func:`repro_torch.kernels.ops.flash_attention`, which takes CPU tensors
to the kernel's plain version). The kernel keeps fp32 scores and
probabilities between bf16 loads and stores, where the portable branches
round scores and probabilities to the activation dtype as the reference
does, so in bf16 the two routes differ by design; in fp32 they agree to
rounding. The kernel has no backward: the attention codec family trains
through the direct branch.

Decode attention (one query against a cache with a length mask) stays
plain torch in both routes: the reference has no kernel for it.

:func:`remat` is the reference's ``jax.checkpoint`` around a block, with
its two policies (``cfg.remat``), for ``loss`` under autograd.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.kernels import ops

NEG_INF = -1e30
_DIRECT_MAX = 4096  # the reference's direct-branch limit on tq (and sqrt(tq*tk))


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, rope_frac: float = 1.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension (d_rot = d*frac)."""
    d_rot = int(d_head * rope_frac)
    d_rot -= d_rot % 2
    return 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                         device=device) / d_rot))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_frac: float = 1.0) -> torch.Tensor:
    """x (B, T, H, D), positions (B, T) int; rotates the first
    ``d_rot = D * rope_frac`` dims and passes the rest through."""
    inv = rope_freqs(x.shape[-1], theta, rope_frac, x.device)
    ang = positions[..., None].float() * inv  # (B, T, D_rot/2)
    d_rot = 2 * inv.shape[0]
    out = _rotate(x[..., :d_rot], ang)
    return torch.cat([out, x[..., d_rot:]], dim=-1) if x.shape[-1] > d_rot else out


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: x (B, T, H, D), positions (3, B, T) — the
    temporal / height / width streams. The rotary halves split into 3
    sections, each rotated by its own stream; for pure text the streams
    are equal and M-RoPE is RoPE."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)  # (d/2,)
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} do not cover {d // 2} dims")
    sec_id = torch.as_tensor(np.repeat(np.arange(3), np.asarray(sections)),
                             device=x.device)  # (d/2,)
    ang_all = positions[..., None].float() * inv  # (3, B, T, d/2)
    ang = torch.gather(ang_all, 0, sec_id.expand((1,) + ang_all.shape[1:]))[0]
    return _rotate(x, ang)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / (10000 ** (dim / d))
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, Hkv, D) -> (B, T, Hkv*n_rep, D)."""
    if n_rep == 1:
        return x
    b, t, h, d = x.shape
    return x[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(b, t, h * n_rep, d)


def _neg_inf(device) -> torch.Tensor:
    return torch.full((), NEG_INF, device=device)


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
    scores = torch.where(mask, scores, _neg_inf(q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _chunked_attention(q, k, v, *, causal, window, q_offset, q_chunk, k_chunk):
    """Online-softmax attention: a loop over k-chunks inside a loop over
    q-chunks (the reference's two scans). Peak live memory O(q_chunk *
    k_chunk) per head."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    n_q = -(-tq // q_chunk)
    n_k = -(-tk // k_chunk)
    pad_q, pad_k = n_q * q_chunk - tq, n_k * k_chunk - tk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    qs = q.reshape(b, n_q, q_chunk, h, d).permute(1, 0, 3, 2, 4)  # (nq,B,H,qc,d)
    ks = k.reshape(b, n_k, k_chunk, h, d).permute(1, 0, 3, 2, 4)
    vs = v.reshape(b, n_k, k_chunk, h, d).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(n_q):
        qc = qs[qi]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, h, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, h, q_chunk), device=dev)
        acc = torch.zeros((b, h, q_chunk, d), device=dev)
        for ki in range(n_k):
            kc, vc = ks[ki], vs[ki]
            k_pos = ki * k_chunk + torch.arange(k_chunk, device=dev)
            s = torch.einsum("bhqd,bhkd->bhqk", qc, kc).float() * scale
            mask = (k_pos[None, :] < tk).expand(q_chunk, k_chunk)  # k padding
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, _neg_inf(dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vc.dtype), vc).float()
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, n_q * q_chunk, h, d)
    return out[:, :tq]


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
          window: int) -> torch.Tensor:
    """The kernel route: q (B, Tq, H, D), k and v (B, Tk, Hkv, D) -> (B,
    Tq, H, D), one launch. Repeating the KV heads and the layout change
    are copies (at one KV head, H copies of K and V)."""
    n_rep = q.shape[2] // k.shape[2]
    qh, kh, vh = (t.transpose(1, 2).contiguous()
                  for t in (q, repeat_kv(k, n_rep), repeat_kv(v, n_rep)))
    o = ops.flash_attention(qh, kh, vh, causal=causal, window=window,
                            device=q.device)
    return o.transpose(1, 2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              q_chunk: int = 512, k_chunk: int = 1024,
              use_kernels: bool = False) -> torch.Tensor:
    """GQA attention; q (B, Tq, H, D), k and v (B, Tk, Hkv, D). The
    kernel route (``use_kernels``) takes queries from position 0."""
    if use_kernels:
        if q_offset:
            raise ValueError("the flash kernel route takes q_offset = 0 only")
        return flash(q, k, v, causal=causal, window=window)
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    tq, tk = q.shape[1], k.shape[1]
    if tq * tk <= _DIRECT_MAX * _DIRECT_MAX and tq <= _DIRECT_MAX:
        return _direct_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    return _chunked_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, q_chunk=q_chunk, k_chunk=k_chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token decode against a (possibly longer-than-valid) KV cache:
    q (B, 1, H, D), caches (B, L, Hkv, D), ``cache_len`` the number of
    valid positions (an int or a 0-d tensor, read on the device)."""
    n_rep = q.shape[2] // k_cache.shape[2]
    k = repeat_kv(k_cache, n_rep)
    v = repeat_kv(v_cache, n_rep)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos < cache_len
    if window > 0:
        mask &= kpos > cache_len - window
    s = torch.where(mask, s, _neg_inf(q.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The identity: the reference's sharding-constraint lever has nothing
    to pin in a package with no partitioner (``parallel/sharding`` only
    accounts)."""
    del spec
    return x


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE over logits (B, T, V) and int labels (B, T)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


# --------------------------------------------------------------------------
# Rematerialisation
# --------------------------------------------------------------------------
# dot_general with no batch dimensions is a 2-D product: a weight matmul
# (``x @ w`` dispatches to aten.mm); attention's and the MoE experts'
# batched products (aten.bmm) are recomputed like everything else
_SAVEABLE_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    if op in _SAVEABLE_DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, mode: str):
    """``fn`` under the reference's ``cfg.remat`` policy, for the backward:
    ``"none"`` keeps every activation; ``"full"`` (``nothing_saveable``)
    keeps only the block's inputs and recomputes the block in the
    backward; ``"dots"`` (``dots_with_no_batch_dims_saveable``) also keeps
    the outputs of the weight matmuls. Outside grad mode nothing is kept
    anyway, and ``fn`` runs as it is. Recomputation repeats the forward's
    operations on the same inputs, so the gradients' bits do not depend on
    the mode."""
    if mode not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat mode {mode!r}")
    if mode == "none":
        return fn
    kw = {"use_reentrant": False}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return _ckpt.checkpoint(fn, *args, **kw)

    return wrapped
