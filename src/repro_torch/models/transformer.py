"""Decoder-only transformer LM: dense GQA, MoE, and VLM (M-RoPE) variants.

Port of the JAX package's ``models/transformer.py``, eager, with the same
parameter paths, the same (in, out) weight layouts (``x @ w``) and the
same cache dicts:

* parameters arrive as a flat ``{dotted path: tensor}`` dict (what
  :meth:`DecoderLM.init` and :func:`repro_torch.convert.lm_from_reference`
  give); layer stacks keep their leading "layers" axis, and both
  ``scan_layers`` settings are one loop over it;
* prefill attention goes through the flash kernel when
  ``cfg.use_kernels`` (see :mod:`repro_torch.models.common`); decode
  attention is plain torch on both routes;
* MoE is the reference's sort-based capacity dispatch: stable sort of the
  expert ids (``jnp.argsort`` is stable), slots ``starts = cumsum(counts)
  - counts``, drops past the capacity into a scratch row. Combining the
  experts' outputs sums each token's ``top_k`` contributions in top-k order
  (a gather, no atomics, so the same inputs give the same bits on the
  card); the reference scatter-adds them in expert order, which differs
  from it by rounding only;
* ``loss`` runs under autograd, each layer under ``cfg.remat``
  (:func:`repro_torch.models.common.remat`); ``prefill`` and
  ``decode_step`` run without gradients;
* ``decode_step`` writes the new position into the cache's tensors in
  place and returns the cache (the reference returns new arrays); the
  position it writes at is read on the device, so a step does not wait
  for the host.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import common
from repro_torch.nn.module import (Param, init_tree, nest, pspec_tree, spec_tree,
                                   stack_defs)


# --------------------------------------------------------------------------
# Param-def helpers
# --------------------------------------------------------------------------
def _norm_defs(cfg: ArchConfig, dim: Optional[int] = None):
    dim = dim or cfg.d_model
    d = {"scale": Param((dim,), torch.float32, "ones", (None,))}
    if cfg.norm == "layer":
        d["bias"] = Param((dim,), torch.float32, "zeros", (None,))
    return d


def _apply_norm(cfg: ArchConfig, p, x, eps: float = 1e-6):
    x32 = x.float()
    if cfg.norm == "layer":
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def layer(stacked, i: int):
    """Layer ``i`` of a tree of stacked tensors (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, tokens, axis=0)``."""
    return table.index_select(0, tokens.reshape(-1)).reshape(*tokens.shape, -1)


def positions_at(clen: torch.Tensor, b: int) -> torch.Tensor:
    """(B, 1) int32 positions of a decode step at cache length ``clen``."""
    return clen.reshape(1, 1).expand(b, 1).to(torch.int32)


def write_at(cache: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """In place: ``cache[:, pos] = new[:, 0]`` over the time axis 1."""
    cache.index_copy_(1, pos.reshape(1).long(), new)


# --------------------------------------------------------------------------
# Attention sub-module
# --------------------------------------------------------------------------
def _attn_defs(cfg: ArchConfig):
    dm, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.dtype
    d = {
        "wq": Param((dm, nh * hd), dt, "fan_in", ("embed", "heads")),
        "wk": Param((dm, nkv * hd), dt, "fan_in", ("embed", "kv_heads")),
        "wv": Param((dm, nkv * hd), dt, "fan_in", ("embed", "kv_heads")),
        "wo": Param((nh * hd, dm), dt, "fan_in", ("heads", "embed")),
    }
    if cfg.qkv_bias:
        d["bq"] = Param((nh * hd,), dt, "zeros", ("heads",))
        d["bk"] = Param((nkv * hd,), dt, "zeros", ("kv_heads",))
        d["bv"] = Param((nkv * hd,), dt, "zeros", ("kv_heads",))
    return d


def _project_qkv(cfg: ArchConfig, p, x):
    b, t, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, t, cfg.n_heads, hd), k.reshape(b, t, cfg.n_kv_heads, hd),
            v.reshape(b, t, cfg.n_kv_heads, hd))


def _rope_qk(cfg: ArchConfig, q, k, positions):
    if cfg.rope_theta <= 0:
        return q, k
    if cfg.mrope_sections:
        return (common.apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                common.apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return (common.apply_rope(q, positions, cfg.rope_theta, cfg.rope_frac),
            common.apply_rope(k, positions, cfg.rope_theta, cfg.rope_frac))


def _attn_forward(cfg: ArchConfig, p, x, positions, *, causal=True):
    b, t, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions)
    o = common.attention(q, k, v, causal=causal, window=cfg.window,
                         use_kernels=cfg.use_kernels)
    return o.reshape(b, t, -1) @ p["wo"], (k, v)


def _quant_kv(x):
    """int8 symmetric per-(token, head) quantization of the KV cache."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(-1, keepdim=True), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -128, 127).to(torch.int8)
    return q, scale


def _attn_decode_quant(cfg: ArchConfig, p, x, positions, kq, vq, ks, vs,
                       cache_len):
    """Single-token decode against an int8 KV cache (updated in place)."""
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions)
    k_new_q, k_new_s = _quant_kv(k)
    v_new_q, v_new_s = _quant_kv(v)
    for cache, new in ((kq, k_new_q), (vq, v_new_q), (ks, k_new_s), (vs, v_new_s)):
        write_at(cache, cache_len, new)
    k_deq = (kq.float() * ks).to(cfg.dtype)
    v_deq = (vq.float() * vs).to(cfg.dtype)
    o = common.decode_attention(q, k_deq, v_deq, cache_len + 1, window=cfg.window)
    return o.reshape(b, 1, -1) @ p["wo"]


def _attn_decode(cfg: ArchConfig, p, x, positions, k_cache, v_cache, cache_len):
    """x: (B, 1, D); writes the new K/V at ``cache_len`` (in place)."""
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions)
    write_at(k_cache, cache_len, k)
    write_at(v_cache, cache_len, v)
    o = common.decode_attention(q, k_cache, v_cache, cache_len + 1,
                                window=cfg.window)
    return o.reshape(b, 1, -1) @ p["wo"]


# --------------------------------------------------------------------------
# FFN sub-modules
# --------------------------------------------------------------------------
def _ffn_defs(cfg: ArchConfig):
    dm, df, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        "wg": Param((dm, df), dt, "fan_in", ("embed", "mlp")),
        "wu": Param((dm, df), dt, "fan_in", ("embed", "mlp")),
        "wd": Param((df, dm), dt, "fan_in", ("mlp", "embed")),
    }


def _ffn_forward(p, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def _moe_defs(cfg: ArchConfig):
    dm, df, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype
    return {
        "router": Param((dm, e), torch.float32, "fan_in", ("embed", None)),
        "wg": Param((e, dm, df), dt, "fan_in", ("expert", "embed", "mlp")),
        "wu": Param((e, dm, df), dt, "fan_in", ("expert", "embed", "mlp")),
        "wd": Param((e, df, dm), dt, "fan_in", ("expert", "mlp", "embed")),
    }


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    cap = int(np.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-cap // 8) * 8)  # round up to 8, as the reference


def expert_counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=e)`` as an integer scatter-add, which
    has a meta kernel (``bincount`` has none), so the dry run counts an MoE
    step; integer sums in any order are the same counts."""
    ids = ids.reshape(-1).long()
    return torch.zeros(e, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def moe_dispatch(cfg: ArchConfig, p, xf):
    """The routing of N tokens xf (N, D): returns (top_w (N, k), top_i (N,
    k), probs (N, E), order, slot, keep), the last three over the N*k
    assignments in stably sorted expert order; ``keep`` is False where an
    assignment overflowed its expert's capacity (dropped)."""
    e, k = cfg.n_experts, cfg.moe_top_k
    n = xf.shape[0]
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    cap = moe_capacity(cfg, n)
    counts = expert_counts(se, e)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(se.numel(), device=xf.device) - starts[se]
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, torch.full_like(se, e * cap))
    return top_w, top_i, probs, order, slot, keep


def _moe_forward(cfg: ArchConfig, p, x):
    """Sort-based capacity-constrained top-k dispatch; returns (y, aux)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    n = b * t
    xf = x.reshape(n, d)
    top_w, top_i, probs, order, slot, keep = moe_dispatch(cfg, p, xf)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(0)
    ce = expert_counts(top_i, e).float() / (n * k)
    aux = cfg.router_aux_coef * e * torch.sum(me * ce)

    st = order // k  # token of each sorted assignment
    sw = top_w.reshape(-1)[order]
    cap = moe_capacity(cfg, n)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, xf[st])  # overflow -> the scratch row e*cap
    h = common.constrain(buf[: e * cap].reshape(e, cap, d), "model", None, None)
    g = F.silu(torch.bmm(h, p["wg"]))
    u = torch.bmm(h, p["wu"])
    o = common.constrain(torch.bmm(g * u, p["wd"]), "model", None, None)
    of = o.reshape(e * cap, d)
    contrib = of[torch.clamp(slot, max=e * cap - 1)] * (sw * keep)[:, None].to(x.dtype)
    per_assignment = torch.empty_like(contrib)
    per_assignment[order] = contrib  # back to (token, top-k) order
    y = per_assignment.reshape(n, k, d).sum(1)
    return y.reshape(b, t, d), aux


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------
class DecoderLM:
    """Dense (llama/qwen/yi/stablelm), MoE (qwen3-moe/dbrx) and VLM
    (qwen2-vl) families."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # ---- definitions ---------------------------------------------------
    def _layer_defs(self):
        cfg = self.cfg
        return {
            "ln1": _norm_defs(cfg),
            "attn": _attn_defs(cfg),
            "ln2": _norm_defs(cfg),
            "ffn": _moe_defs(cfg) if cfg.n_experts else _ffn_defs(cfg),
        }

    @property
    def defs(self):
        cfg = self.cfg
        d: dict[str, Any] = {
            "embed": Param((cfg.vocab, cfg.d_model), cfg.dtype, "normal_0.02",
                           (None, "embed_shard")),
            "lm_head": Param((cfg.d_model, cfg.vocab), cfg.dtype, "fan_in",
                             ("embed", "vocab")),
            "ln_f": _norm_defs(cfg),
            "layers": stack_defs(self._layer_defs(), cfg.n_layers),
        }
        if cfg.is_vlm:
            d["patch_proj"] = Param((cfg.d_patch, cfg.d_model), cfg.dtype,
                                    "fan_in", (None, "embed"))
        return d

    def init(self, seed: int = 0, device: DeviceLike = None) -> dict[str, torch.Tensor]:
        return init_tree(self.defs, seed, device)

    def specs(self) -> dict[str, torch.Tensor]:
        return spec_tree(self.defs)

    def pspecs(self, rules) -> dict:
        return pspec_tree(self.defs, rules)

    # ---- blocks ----------------------------------------------------------
    def _ffn(self, p, normed):
        if self.cfg.n_experts:
            return _moe_forward(self.cfg, p, normed)
        return _ffn_forward(p, normed), torch.zeros((), device=normed.device)

    def _block(self, p, x, positions):
        cfg = self.cfg
        h, kv = _attn_forward(cfg, p["attn"], _apply_norm(cfg, p["ln1"], x), positions)
        x = x + h
        f, aux = self._ffn(p["ffn"], _apply_norm(cfg, p["ln2"], x))
        return x + f, aux, kv

    def _constrain(self, x):
        if self.cfg.constrain_acts:
            return common.constrain(x, self.cfg.constrain_acts, None, None)
        return x

    def _stack(self, params, x, positions, collect_kv=False):
        """Every layer in order; returns (x, aux, [(k, v)] if collect_kv).
        Without ``collect_kv`` (the loss) each layer runs under
        ``cfg.remat`` (:func:`repro_torch.models.common.remat`)."""
        aux = torch.zeros((), device=x.device)
        kvs = []
        x = self._constrain(x)
        block = common.remat(lambda p, x, pos: self._block(p, x, pos)[:2],
                             self.cfg.remat)
        for i in range(self.cfg.n_layers):
            p = layer(params["layers"], i)
            if collect_kv:
                x, a, kv = self._block(p, x, positions)
                kvs.append(kv)
            else:
                x, a = block(p, x, positions)
            x = self._constrain(x)
            aux = aux + a
        return x, aux, kvs

    # ---- input assembly --------------------------------------------------
    def _assemble(self, params, batch):
        """Returns (x, positions, text_start). For VLM, patch embeddings are
        prepended and M-RoPE position streams are built (t/h/w)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, t = tokens.shape
        dev = tokens.device
        x = embed(params["embed"], tokens)
        if not cfg.is_vlm:
            pos = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t)
            return x, pos, 0
        patches = batch["patches"]  # (B, Np, d_patch)
        npatch = patches.shape[1]
        px = patches.to(cfg.dtype) @ params["patch_proj"]
        x = torch.cat([px, x], dim=1)
        # M-RoPE positions: patches form a sqrt grid at t=0; text advances t.
        side = max(1, int(np.sqrt(npatch)))
        grid_h = (np.arange(npatch) // side).astype(np.int32)
        grid_w = (np.arange(npatch) % side).astype(np.int32)
        text_pos = np.arange(t, dtype=np.int32) + int(grid_h.max()) + 1
        pos = np.stack([np.concatenate([np.zeros(npatch, np.int32), text_pos]),
                        np.concatenate([grid_h, text_pos]),
                        np.concatenate([grid_w, text_pos])])
        pos = torch.from_numpy(pos).to(dev)[:, None, :].expand(3, b, npatch + t)
        return x, pos, npatch

    # ---- public API --------------------------------------------------------
    def loss(self, params, batch):
        """Next-token CE (+ MoE aux). batch: tokens (B,T), labels (B,T)
        [+ patches for VLM]. Differentiable (train through
        ``use_kernels=False``: no kernel has a backward)."""
        cfg = self.cfg
        params = nest(params)
        x, pos, text_start = self._assemble(params, batch)
        x, aux, _ = self._stack(params, x, pos)
        x = _apply_norm(cfg, params["ln_f"], x)
        if text_start:
            x = x[:, text_start:]
        logits = x @ params["lm_head"]
        return common.cross_entropy(logits, batch["labels"]) + aux

    @torch.no_grad()
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Full-sequence forward producing KV caches + last-position logits.

        ``max_len`` sizes the cache (room for decode_step growth); defaults
        to sequence length + 64."""
        cfg = self.cfg
        params = nest(params)
        x, pos, _ = self._assemble(params, batch)
        x, _, kvs = self._stack(params, x, pos, collect_kv=True)
        x = _apply_norm(cfg, params["ln_f"], x)
        logits = x[:, -1:] @ params["lm_head"]
        b, t_total = x.shape[:2]
        max_len = max_len or t_total + 64
        cache_len = max(max_len, t_total)
        cache = {}
        for name, i in (("k", 0), ("v", 1)):
            c = torch.zeros((cfg.n_layers, b, cache_len, cfg.n_kv_heads, cfg.head_dim),
                            dtype=kvs[0][i].dtype, device=x.device)
            for layer_i, kv in enumerate(kvs):
                c[layer_i, :, :t_total] = kv[i]
            cache[name] = c
        cache["len"] = torch.tensor(t_total, dtype=torch.int32, device=x.device)
        if cfg.mrope_sections:
            # M-RoPE: the *position* stream advances past the max grid index,
            # not past the raw cache length.
            cache["pos_next"] = pos[0, 0, -1] + 1
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """One token for every sequence. tokens: (B, 1). Writes into the
        cache's tensors and returns the cache with ``len`` (and
        ``pos_next``) advanced."""
        cfg = self.cfg
        params = nest(params)
        b = tokens.shape[0]
        x = embed(params["embed"], tokens)
        clen = cache["len"]
        if cfg.mrope_sections:
            p_next = cache.get("pos_next", clen)
            pos = p_next.reshape(1, 1, 1).expand(3, b, 1).to(torch.int32)
        else:
            pos = positions_at(clen, b)
        for i in range(cfg.n_layers):
            p = layer(params["layers"], i)
            normed = _apply_norm(cfg, p["ln1"], x)
            if cfg.kv_quant:
                h = _attn_decode_quant(cfg, p["attn"], normed, pos, cache["k_q"][i],
                                       cache["v_q"][i], cache["k_s"][i],
                                       cache["v_s"][i], clen)
            else:
                h = _attn_decode(cfg, p["attn"], normed, pos, cache["k"][i],
                                 cache["v"][i], clen)
            x = x + h
            f, _ = self._ffn(p["ffn"], _apply_norm(cfg, p["ln2"], x))
            x = x + f
        x = _apply_norm(cfg, params["ln_f"], x)
        logits = x @ params["lm_head"]
        new_cache = dict(cache, len=clen + 1)
        if cfg.mrope_sections:
            new_cache["pos_next"] = cache.get("pos_next", clen) + 1
        return logits, new_cache

    def quantize_cache(self, cache):
        """The dense prefill cache in decode_step's int8 layout (``k_q``,
        ``v_q`` int8, ``k_s``, ``v_s`` fp32 scales per (token, head)) —
        what the reference's tests do by hand with ``_quant_kv``."""
        kq, ks = _quant_kv(cache["k"])
        vq, vs = _quant_kv(cache["v"])
        out = {"k_q": kq, "v_q": vq, "k_s": ks, "v_s": vs, "len": cache["len"]}
        if "pos_next" in cache:
            out["pos_next"] = cache["pos_next"]
        return out

    # ---- cache specs (meta stand-ins) -------------------------------------
    def cache_specs(self, batch: int, max_len: int):
        cfg = self.cfg
        kv_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        if cfg.kv_quant:
            s_shape = kv_shape[:-1] + (1,)
            out = {"k_q": meta(kv_shape, torch.int8), "v_q": meta(kv_shape, torch.int8),
                   "k_s": meta(s_shape, torch.float32),
                   "v_s": meta(s_shape, torch.float32)}
        else:
            out = {"k": meta(kv_shape, cfg.dtype), "v": meta(kv_shape, cfg.dtype)}
        out["len"] = meta((), torch.int32)
        if cfg.mrope_sections:
            out["pos_next"] = meta((), torch.int32)
        return out
