"""RecurrentGemma / Griffin [arXiv:2402.19427] hybrid model.

Port of the JAX package's ``models/rglru.py``: residual blocks in the
pattern (recurrent, recurrent, attention) — local sliding-window MQA every
3rd block. Recurrent block: two input branches (GeLU gate | conv1d(4) ->
RG-LRU), elementwise product, output projection. RG-LRU:

  r_t = sigmoid(W_a x_t + b_a)          # recurrence gate
  i_t = sigmoid(W_x x_t + b_x)          # input gate
  a_t = exp(-c * softplus(L) * r_t)     # data-dependent decay, c = 8
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

In sequence mode the diagonal recurrence runs in fp32 through the
hand-written ``rglru_scan`` (one launch per recurrent block) when
``cfg.use_kernels``, else as the reference's parallel prefix (its
``associative_scan`` combine, here a doubling scan over time). The kernel
is sequential, so the two agree to fp32 rounding, not bitwise; it clamps a
to [1e-37, 1] before its logs, where the model's a lies in (0, 1]. Decode
is one fused step on both routes and launches no kernel. The local
attention (head dim 256, window 2048) runs through flash in prefill.

``loss`` runs under autograd, each period rematerialised unless
``cfg.remat`` is "none".

Layer stacking: the stacked (rec, rec, attn) periods + an unrolled (rec,
rec) tail (8 + 2 = 26 blocks at full size). Prefill keeps the last
``window`` keys and values in a ring buffer: position p at slot p % window.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.transformer import (
    _apply_norm,
    _attn_defs,
    _attn_forward,
    _norm_defs,
    _project_qkv,
    _rope_qk,
    embed,
    layer,
    positions_at,
    write_at,
)
from repro_torch.nn.module import (Param, init_tree, nest, pspec_tree, spec_tree,
                                   stack_defs)

_C = 8.0  # Griffin's fixed decay sharpness


def _lru_init(gen, shape, device):
    # Lambda initialized so a = sigma(L)^c spreads over (0.9, 0.999)
    u = 0.9 + (0.999 - 0.9) * torch.rand(shape, generator=gen, device=device)
    a = u ** (1.0 / _C)
    return torch.log(a / (1.0 - a))


def _rec_defs(cfg: ArchConfig):
    d, w, dt = cfg.d_model, cfg.rglru_width or cfg.d_model, cfg.dtype
    cw = cfg.conv1d_width
    f32 = torch.float32
    return {
        "w_gate": Param((d, w), dt, "fan_in", ("embed", "mlp")),
        "w_in": Param((d, w), dt, "fan_in", ("embed", "mlp")),
        "conv_w": Param((cw, w), dt, "fan_in", (None, "mlp")),
        "conv_b": Param((w,), dt, "zeros", ("mlp",)),
        "lru_lambda": Param((w,), f32, _lru_init, ("mlp",)),
        "wa": Param((w, w), dt, "fan_in", ("mlp", None)),
        "ba": Param((w,), f32, "zeros", ("mlp",)),
        "wx": Param((w, w), dt, "fan_in", ("mlp", None)),
        "bx": Param((w,), f32, "zeros", ("mlp",)),
        "w_out": Param((w, d), dt, "fan_in", ("mlp", "embed")),
    }


def _mlp_defs(cfg: ArchConfig):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        "wg": Param((d, f), dt, "fan_in", ("embed", "mlp")),
        "wu": Param((d, f), dt, "fan_in", ("embed", "mlp")),
        "wd": Param((f, d), dt, "fan_in", ("mlp", "embed")),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _geglu(p, x):
    return (_gelu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def prefix_scan(a, g):
    """Inclusive scan of ``h_t = a_t h_{t-1} + g_t`` from h = 0 over axis 1
    with the reference's combine ``(a_l a_r, g_l a_r + g_r)``, by doubling:
    log2(T) rounds. Returns (a_1 ... a_t, h_t) for every t."""
    t, shift = a.shape[1], 1
    while shift < t:
        g = torch.cat([g[:, :shift], g[:, :-shift] * a[:, shift:] + g[:, shift:]], 1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], 1)
        shift *= 2
    return a, g


def _gates(p, x):
    r = torch.sigmoid((x @ p["wa"]).float() + p["ba"])
    i = torch.sigmoid((x @ p["wx"]).float() + p["bx"])
    a = torch.exp(-_C * F.softplus(p["lru_lambda"]) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * x.float()
    return a, gated


def _rglru_seq(p, x, h0, use_kernels):
    """x: (B, T, W) gated input; h0: (B, W) fp32. Returns (h in x's dtype,
    h_T fp32)."""
    a, gated = _gates(p, x)
    if use_kernels:
        h, h_last = ops.rglru_scan_op(a.contiguous(), gated.contiguous(),
                                      h0.float().contiguous(), device=x.device)
        return h.to(x.dtype), h_last
    a_seq, g_seq = prefix_scan(a, gated)
    h = g_seq + a_seq * h0[:, None, :]
    return h.to(x.dtype), h[:, -1, :]


def _conv1d_seq(p, x, tail):
    """Causal depthwise conv, width cw. tail: (B, cw-1, W) left context."""
    cw = p["conv_w"].shape[0]
    xx = torch.cat([tail.to(x.dtype), x], dim=1)
    out = sum(xx[:, i: i + x.shape[1], :] * p["conv_w"][i] for i in range(cw))
    return out + p["conv_b"], xx[:, -(cw - 1):, :]


def _rec_block_seq(p, x, state, use_kernels):
    """state: {h: (B,W), conv: (B,cw-1,W)}."""
    gate = _gelu(x @ p["w_gate"])
    u, conv_tail = _conv1d_seq(p, x @ p["w_in"], state["conv"])
    h, h_last = _rglru_seq(p, u, state["h"], use_kernels)
    return (gate * h) @ p["w_out"], {"h": h_last.float(), "conv": conv_tail}


def _rec_block_step(p, x, state):
    """Single-token decode step. x: (B, 1, D)."""
    gate = _gelu(x @ p["w_gate"])
    u = x @ p["w_in"]
    cw = p["conv_w"].shape[0]
    xx = torch.cat([state["conv"].to(x.dtype), u], dim=1)  # (B,cw,W)
    u = sum(xx[:, i: i + 1, :] * p["conv_w"][i] for i in range(cw)) + p["conv_b"]
    a, gated = _gates(p, u)
    h = a[:, 0] * state["h"] + gated[:, 0]
    out = (gate * h[:, None, :].to(x.dtype)) @ p["w_out"]
    return out, {"h": h, "conv": xx[:, 1:, :]}


class RecurrentGemma:
    def __init__(self, cfg: ArchConfig):
        if cfg.attn_period != 3:
            raise ValueError("RecurrentGemma takes attn_period = 3")
        self.cfg = cfg
        self.n_periods = cfg.n_layers // 3  # full (rec, rec, attn) periods
        self.n_tail = cfg.n_layers - 3 * self.n_periods  # trailing rec blocks

    # ---- defs ---------------------------------------------------------
    def _period_defs(self):
        cfg = self.cfg
        return {
            "ln_r1": _norm_defs(cfg), "rec1": _rec_defs(cfg),
            "ln_m1": _norm_defs(cfg), "mlp1": _mlp_defs(cfg),
            "ln_r2": _norm_defs(cfg), "rec2": _rec_defs(cfg),
            "ln_m2": _norm_defs(cfg), "mlp2": _mlp_defs(cfg),
            "ln_a": _norm_defs(cfg), "attn": _attn_defs(cfg),
            "ln_m3": _norm_defs(cfg), "mlp3": _mlp_defs(cfg),
        }

    def _tail_defs(self):
        cfg = self.cfg
        d = {}
        for i in range(self.n_tail):
            d[f"ln_r{i}"] = _norm_defs(cfg)
            d[f"rec{i}"] = _rec_defs(cfg)
            d[f"ln_m{i}"] = _norm_defs(cfg)
            d[f"mlp{i}"] = _mlp_defs(cfg)
        return d

    @property
    def defs(self):
        cfg = self.cfg
        d: dict[str, Any] = {
            "embed": Param((cfg.vocab, cfg.d_model), cfg.dtype, "normal_0.02",
                           (None, "embed_shard")),
            "ln_f": _norm_defs(cfg),
            "lm_head": Param((cfg.d_model, cfg.vocab), cfg.dtype, "fan_in",
                             ("embed", "vocab")),
            "periods": stack_defs(self._period_defs(), self.n_periods),
        }
        if self.n_tail:
            d["tail"] = self._tail_defs()
        return d

    def init(self, seed: int = 0, device: DeviceLike = None) -> dict[str, torch.Tensor]:
        return init_tree(self.defs, seed, device)

    def specs(self) -> dict[str, torch.Tensor]:
        return spec_tree(self.defs)

    def pspecs(self, rules) -> dict:
        return pspec_tree(self.defs, rules)

    # ---- state --------------------------------------------------------
    def _zero_rec_state(self, b, device):
        cfg = self.cfg
        w = cfg.rglru_width or cfg.d_model
        return {
            "h": torch.zeros((b, w), device=device),
            "conv": torch.zeros((b, cfg.conv1d_width - 1, w), dtype=cfg.dtype,
                                device=device),
        }

    # ---- sequence mode (loss / prefill) --------------------------------
    def _period_seq(self, p, x, positions):
        cfg, uk = self.cfg, self.cfg.use_kernels
        b = x.shape[0]
        h, st1 = _rec_block_seq(p["rec1"], _apply_norm(cfg, p["ln_r1"], x),
                                self._zero_rec_state(b, x.device), uk)
        x = x + h
        x = x + _geglu(p["mlp1"], _apply_norm(cfg, p["ln_m1"], x))
        h, st2 = _rec_block_seq(p["rec2"], _apply_norm(cfg, p["ln_r2"], x),
                                self._zero_rec_state(b, x.device), uk)
        x = x + h
        x = x + _geglu(p["mlp2"], _apply_norm(cfg, p["ln_m2"], x))
        h, kv = _attn_forward(cfg, p["attn"], _apply_norm(cfg, p["ln_a"], x),
                              positions)
        x = x + h
        x = x + _geglu(p["mlp3"], _apply_norm(cfg, p["ln_m3"], x))
        return x, {"r1": st1, "r2": st2}, kv

    def _tail_seq(self, params, x):
        cfg = self.cfg
        tp, states = params.get("tail", {}), {}
        for i in range(self.n_tail):
            h, st = _rec_block_seq(tp[f"rec{i}"], _apply_norm(cfg, tp[f"ln_r{i}"], x),
                                   self._zero_rec_state(x.shape[0], x.device),
                                   cfg.use_kernels)
            x = x + h
            x = x + _geglu(tp[f"mlp{i}"], _apply_norm(cfg, tp[f"ln_m{i}"], x))
            states[f"t{i}"] = st
        return x, states

    def _embed_positions(self, params, tokens):
        b, t = tokens.shape
        pos = torch.arange(t, dtype=torch.int32, device=tokens.device).expand(b, t)
        return embed(params["embed"], tokens), pos

    # ---- public -----------------------------------------------------------
    def loss(self, params, batch):
        """Next-token CE, differentiable; each (rec, rec, attn) period under
        ``cfg.remat`` (any mode other than "none" keeps nothing, as the
        reference; the tail blocks are not rematerialised)."""
        cfg = self.cfg
        params = nest(params)
        x, pos = self._embed_positions(params, batch["tokens"])
        period = common.remat(lambda p, x, pos: self._period_seq(p, x, pos)[0],
                              "none" if cfg.remat == "none" else "full")
        for i in range(self.n_periods):
            x = period(layer(params["periods"], i), x, pos)
        x, _ = self._tail_seq(params, x)
        logits = _apply_norm(cfg, params["ln_f"], x) @ params["lm_head"]
        return common.cross_entropy(logits, batch["labels"])

    @torch.no_grad()
    def prefill(self, params, batch, max_len=None):
        """Prefill keeping only the last `window` KV entries + rec states.
        (max_len ignored — the KV ring buffer is window-bounded.)"""
        del max_len
        cfg = self.cfg
        params = nest(params)
        tokens = batch["tokens"]
        t = tokens.shape[1]
        x, pos = self._embed_positions(params, tokens)
        win = cfg.window
        sts, ks, vs = [], [], []
        for i in range(self.n_periods):
            x, st, (k, v) = self._period_seq(layer(params["periods"], i), x, pos)
            sts.append(st)
            for out, kv in ((ks, k), (vs, v)):
                if t >= win:  # ring-buffer alignment: position p at slot p % window
                    out.append(torch.roll(kv[:, -win:], t % win, dims=1))
                else:
                    out.append(F.pad(kv, (0, 0, 0, 0, 0, win - t)))
        x, tail_sts = self._tail_seq(params, x)
        logits = _apply_norm(cfg, params["ln_f"], x)[:, -1:] @ params["lm_head"]
        periods = {r: {leaf: torch.stack([st[r][leaf] for st in sts])
                       for leaf in ("h", "conv")} for r in ("r1", "r2")}
        cache = {
            "periods": periods,
            "tail": tail_sts,
            "k": torch.stack(ks),
            "v": torch.stack(vs),
            "len": torch.tensor(t, dtype=torch.int32, device=tokens.device),
        }
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """One token; the ring buffer's slot ``len % window`` is written in
        place, the recurrent states are replaced."""
        cfg = self.cfg
        params = nest(params)
        b = tokens.shape[0]
        x = embed(params["embed"], tokens)
        clen = cache["len"]
        pos = positions_at(clen, b)
        wpos = torch.remainder(clen, cfg.window)  # ring-buffer write position
        valid = torch.clamp(clen + 1, max=cfg.window)
        new_sts = []
        for i in range(self.n_periods):
            p, st = layer(params["periods"], i), layer(cache["periods"], i)
            h, st1 = _rec_block_step(p["rec1"], _apply_norm(cfg, p["ln_r1"], x), st["r1"])
            x = x + h
            x = x + _geglu(p["mlp1"], _apply_norm(cfg, p["ln_m1"], x))
            h, st2 = _rec_block_step(p["rec2"], _apply_norm(cfg, p["ln_r2"], x), st["r2"])
            x = x + h
            x = x + _geglu(p["mlp2"], _apply_norm(cfg, p["ln_m2"], x))
            # local attention against the ring buffer
            q, k, v = _project_qkv(cfg, p["attn"], _apply_norm(cfg, p["ln_a"], x))
            q, k = _rope_qk(cfg, q, k, pos)
            write_at(cache["k"][i], wpos, k)
            write_at(cache["v"][i], wpos, v)
            o = common.decode_attention(q, cache["k"][i], cache["v"][i], valid)
            x = x + o.reshape(b, 1, -1) @ p["attn"]["wo"]
            x = x + _geglu(p["mlp3"], _apply_norm(cfg, p["ln_m3"], x))
            new_sts.append({"r1": st1, "r2": st2})
        new_tail = {}
        tp = params.get("tail", {})
        for i in range(self.n_tail):
            h, st = _rec_block_step(tp[f"rec{i}"], _apply_norm(cfg, tp[f"ln_r{i}"], x),
                                    cache["tail"][f"t{i}"])
            x = x + h
            x = x + _geglu(tp[f"mlp{i}"], _apply_norm(cfg, tp[f"ln_m{i}"], x))
            new_tail[f"t{i}"] = st
        logits = _apply_norm(cfg, params["ln_f"], x) @ params["lm_head"]
        periods = {r: {leaf: torch.stack([st[r][leaf] for st in new_sts])
                       for leaf in ("h", "conv")} for r in ("r1", "r2")}
        return logits, {"periods": periods, "tail": new_tail, "k": cache["k"],
                        "v": cache["v"], "len": clen + 1}

    def cache_specs(self, batch: int, max_len: int):
        """KV is window-bounded; recurrent state O(1) (meta tensors)."""
        cfg = self.cfg
        w = cfg.rglru_width or cfg.d_model
        npd = self.n_periods
        win = min(cfg.window, max_len)

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        def rec(*lead):
            return {"h": meta((*lead, batch, w), torch.float32),
                    "conv": meta((*lead, batch, cfg.conv1d_width - 1, w), cfg.dtype)}

        kv = (npd, batch, win, cfg.n_kv_heads, cfg.head_dim)
        return {
            "periods": {"r1": rec(npd), "r2": rec(npd)},
            "tail": {f"t{i}": rec() for i in range(self.n_tail)},
            "k": meta(kv, cfg.dtype),
            "v": meta(kv, cfg.dtype),
            "len": meta((), torch.int32),
        }
