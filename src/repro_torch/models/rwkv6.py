"""RWKV-6 "Finch" [arXiv:2404.05892] — attention-free LM with data-dependent
per-channel decay.

Port of the JAX package's ``models/rwkv6.py``. Per layer:
  TimeMix: token-shift with data-dependent lerp (ddlerp, LoRA-parameterized),
    per-channel decay w_t = exp(-exp(w0 + LoRA_w)), bonus u ("time_faaaa");
    per head (dim N): o_t = r_t^T (S_{t-1} + (u*k_t) v_t^T),
                      S_t = diag(w_t) S_{t-1} + k_t v_t^T;
    GroupNorm over heads, SiLU(g) gate, output projection.
  ChannelMix: token-shift, k = relu(W_k x)^2, out = sigmoid(W_r x) * (W_v k).

The sequence form (loss, prefill) carries its (B, H, N, N) state into the
WKV recurrence in fp32, as the reference casts it. With ``cfg.use_kernels``
that is one launch of the hand-written ``rwkv6_scan`` per layer
(:func:`repro_torch.kernels.ops.rwkv6_scan_op`, its plain version on CPU
tensors); otherwise the reference's per-step loop. The kernel clamps w to
[1e-37, 1] before its logs; the model's w lies in (0, 1] and can only
underflow to 0, where the clamp moves the state by at most 1e-37 times
itself. ``decode_step`` is one step of the recurrence, O(1) per token, on
both routes, and launches no kernel. ``loss`` runs under autograd, each
layer rematerialised unless ``cfg.remat`` is "none".
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.transformer import embed, layer
from repro_torch.nn.module import (Param, init_tree, nest, pspec_tree, spec_tree,
                                   stack_defs)


def _time_mix_defs(cfg: ArchConfig):
    d, dt = cfg.d_model, cfg.dtype
    lm, ld = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    nh = d // cfg.rwkv_head_dim
    f32 = torch.float32
    return {
        "mu_base": Param((d,), f32, "zeros", (None,)),
        # ddlerp LoRA: 5 channels (w,k,v,r,g) share A, per-channel B
        "lora_a": Param((d, 5 * lm), dt, "fan_in", ("embed", None)),
        "lora_b": Param((5, lm, d), dt, "zeros", (None, None, "embed")),
        "mu_wkvrg": Param((5, d), f32, "zeros", (None, None)),
        "decay_base": Param((d,), f32, "zeros", (None,)),
        "decay_a": Param((d, ld), dt, "fan_in", ("embed", None)),
        "decay_b": Param((ld, d), dt, "zeros", (None, "embed")),
        "bonus": Param((nh, cfg.rwkv_head_dim), f32, "zeros", ("heads", None)),
        "wr": Param((d, d), dt, "fan_in", ("embed", "heads")),
        "wk": Param((d, d), dt, "fan_in", ("embed", "heads")),
        "wv": Param((d, d), dt, "fan_in", ("embed", "heads")),
        "wg": Param((d, d), dt, "fan_in", ("embed", "heads")),
        "wo": Param((d, d), dt, "fan_in", ("heads", "embed")),
        "gn_scale": Param((d,), f32, "ones", (None,)),
        "gn_bias": Param((d,), f32, "zeros", (None,)),
    }


def _channel_mix_defs(cfg: ArchConfig):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        "mu_k": Param((d,), torch.float32, "zeros", (None,)),
        "mu_r": Param((d,), torch.float32, "zeros", (None,)),
        "wk": Param((d, f), dt, "fan_in", ("embed", "mlp")),
        "wv": Param((f, d), dt, "fan_in", ("mlp", "embed")),
        "wr": Param((d, d), dt, "fan_in", ("embed", None)),
    }


def _ln_defs(d):
    return {
        "scale": Param((d,), torch.float32, "ones", (None,)),
        "bias": Param((d,), torch.float32, "zeros", (None,)),
    }


def _layer_norm(p, x, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def _group_norm(scale, bias, x, nh, eps=1e-5):
    """LayerNorm per head over the flattened (H*N) feature dim."""
    b, t, d = x.shape
    xh = x.reshape(b, t, nh, d // nh).float()
    mu = xh.mean(-1, keepdim=True)
    var = (xh - mu).square().mean(-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b, t, d) * scale + bias).to(x.dtype)


def _token_shift(x, last):
    """Shifted sequence: position t sees x_{t-1}; position 0 sees `last`."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p, x, xs):
    """Data-dependent lerp producing the 5 mixed inputs (w,k,v,r,g)."""
    delta = (xs - x).float()
    x_base = x.float() + delta * p["mu_base"]
    lora = torch.tanh(x_base.to(x.dtype) @ p["lora_a"])  # (B,T,5*lm)
    b, t, _ = x.shape
    lora = lora.reshape(b, t, 5, -1)
    adj = torch.einsum("btcl,cld->btcd", lora, p["lora_b"]).float()
    mix = p["mu_wkvrg"][None, None] + adj  # (B,T,5,D)
    out = x.float()[:, :, None, :] + delta[:, :, None, :] * mix
    return [out[:, :, i, :].to(x.dtype) for i in range(5)]


def wkv_steps(r, k, v, w, u, s0):
    """The reference's WKV recurrence, one step at a time in fp32: r, k, v,
    w (B, T, H, N), u (H, N), s0 (B, H, N, N). Returns (out (B, T, H, N)
    fp32, S_T)."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    uu = u[None, :, :, None]
    s = s0
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + uu * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


class RWKV6:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        if cfg.d_model % cfg.rwkv_head_dim:
            raise ValueError("d_model must be a multiple of rwkv_head_dim")
        self.n_heads = cfg.d_model // cfg.rwkv_head_dim

    def _layer_defs(self):
        cfg = self.cfg
        return {
            "ln1": _ln_defs(cfg.d_model),
            "tm": _time_mix_defs(cfg),
            "ln2": _ln_defs(cfg.d_model),
            "cm": _channel_mix_defs(cfg),
        }

    @property
    def defs(self):
        cfg = self.cfg
        return {
            "embed": Param((cfg.vocab, cfg.d_model), cfg.dtype, "normal_0.02",
                           (None, "embed_shard")),
            "ln_in": _ln_defs(cfg.d_model),
            "ln_f": _ln_defs(cfg.d_model),
            "lm_head": Param((cfg.d_model, cfg.vocab), cfg.dtype, "fan_in",
                             ("embed", "vocab")),
            "layers": stack_defs(self._layer_defs(), cfg.n_layers),
        }

    def init(self, seed: int = 0, device: DeviceLike = None) -> dict[str, torch.Tensor]:
        return init_tree(self.defs, seed, device)

    def specs(self) -> dict[str, torch.Tensor]:
        return spec_tree(self.defs)

    def pspecs(self, rules) -> dict:
        return pspec_tree(self.defs, rules)

    # ---- time mix ---------------------------------------------------------
    def _time_mix_seq(self, p, x, last_x, state, step):
        """x: (B,T,D); last_x: (B,D); state: (B,H,N,N) fp32. ``step``: a
        decode step (no kernel)."""
        cfg = self.cfg
        b, t, d = x.shape
        nh, hn = self.n_heads, cfg.rwkv_head_dim
        xs = _token_shift(x, last_x)
        xw, xk, xv, xr, xg = _ddlerp(p, x, xs)
        decay_adj = torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]
        w = torch.exp(-torch.exp(
            torch.clamp(p["decay_base"] + decay_adj.float(), -18.0, 6.0)))
        r = (xr @ p["wr"]).reshape(b, t, nh, hn)
        k = (xk @ p["wk"]).reshape(b, t, nh, hn)
        v = (xv @ p["wv"]).reshape(b, t, nh, hn)
        g = F.silu(xg @ p["wg"])
        wh = w.reshape(b, t, nh, hn)
        u = p["bonus"].float()
        if cfg.use_kernels and not step:
            out, state = ops.rwkv6_scan_op(
                *(a.float().contiguous() for a in (r, k, v, wh)), u.contiguous(),
                state.contiguous(), device=x.device)
        else:
            out, state = wkv_steps(r, k, v, wh, u, state)
        out = _group_norm(p["gn_scale"], p["gn_bias"],
                          out.reshape(b, t, d).to(x.dtype), nh)
        return (out * g) @ p["wo"], x[:, -1, :], state

    # ---- channel mix -------------------------------------------------------
    def _channel_mix(self, p, x, last_x):
        xs = _token_shift(x, last_x)
        delta = (xs - x).float()
        xk = (x.float() + delta * p["mu_k"]).to(x.dtype)
        xr = (x.float() + delta * p["mu_r"]).to(x.dtype)
        k = torch.square(F.relu(xk @ p["wk"]))
        return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1, :]

    # ---- full model ---------------------------------------------------------
    def _block_seq(self, p, x, state, step):
        """state: dict(tm_x (B,D), cm_x (B,D), s (B,H,N,N))."""
        h, tm_x, s = self._time_mix_seq(
            p["tm"], _layer_norm(p["ln1"], x), state["tm_x"], state["s"], step)
        x = x + h
        h, cm_x = self._channel_mix(p["cm"], _layer_norm(p["ln2"], x), state["cm_x"])
        return x + h, {"tm_x": tm_x, "cm_x": cm_x, "s": s}

    def _zero_state(self, b, device):
        cfg = self.cfg
        l, n = cfg.n_layers, cfg.rwkv_head_dim
        return {
            "tm_x": torch.zeros((l, b, cfg.d_model), dtype=cfg.dtype, device=device),
            "cm_x": torch.zeros((l, b, cfg.d_model), dtype=cfg.dtype, device=device),
            "s": torch.zeros((l, b, self.n_heads, n, n), device=device),
        }

    def _stack(self, params, x, states=None, step=False):
        if states is None:
            states = self._zero_state(x.shape[0], x.device)
        outs = []
        for i in range(self.cfg.n_layers):
            x, st = self._block_seq(layer(params["layers"], i), x,
                                    layer(states, i), step)
            outs.append(st)
        return x, {k: torch.stack([o[k] for o in outs]) for k in ("tm_x", "cm_x", "s")}

    def _trunk(self, params, tokens):
        return _layer_norm(params["ln_in"], embed(params["embed"], tokens))

    def loss(self, params, batch):
        """Next-token CE, differentiable; each layer under ``cfg.remat``
        (any mode other than "none" keeps nothing, as the reference)."""
        params = nest(params)
        x = self._trunk(params, batch["tokens"])
        zero = self._zero_state(x.shape[0], x.device)
        block = common.remat(lambda p, x, st: self._block_seq(p, x, st, False)[0],
                             "none" if self.cfg.remat == "none" else "full")
        for i in range(self.cfg.n_layers):
            x = block(layer(params["layers"], i), x, layer(zero, i))
        logits = _layer_norm(params["ln_f"], x) @ params["lm_head"]
        return common.cross_entropy(logits, batch["labels"])

    @torch.no_grad()
    def prefill(self, params, batch, max_len=None):
        del max_len  # recurrent state is O(1); nothing to size
        params = nest(params)
        tokens = batch["tokens"]
        x, states = self._stack(params, self._trunk(params, tokens))
        logits = _layer_norm(params["ln_f"], x)[:, -1:] @ params["lm_head"]
        states["len"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device)
        return logits, states

    @torch.no_grad()
    def decode_step(self, params, state, tokens):
        """tokens (B,1); state from prefill (or zeros of cache_specs' shapes)."""
        params = nest(params)
        inner = {k: state[k] for k in ("tm_x", "cm_x", "s")}
        x, new_states = self._stack(params, self._trunk(params, tokens),
                                    states=inner, step=True)
        logits = _layer_norm(params["ln_f"], x) @ params["lm_head"]
        new_states["len"] = state["len"] + 1
        return logits, new_states

    def cache_specs(self, batch: int, max_len: int) -> dict[str, Any]:
        """Recurrent state is O(1) in sequence length (meta tensors)."""
        del max_len
        cfg = self.cfg
        l, n = cfg.n_layers, cfg.rwkv_head_dim

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        return {
            "tm_x": meta((l, batch, cfg.d_model), cfg.dtype),
            "cm_x": meta((l, batch, cfg.d_model), cfg.dtype),
            "s": meta((l, batch, self.n_heads, n, n), torch.float32),
            "len": meta((), torch.int32),
        }
