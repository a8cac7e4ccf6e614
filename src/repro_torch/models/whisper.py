"""Whisper encoder-decoder backbone [arXiv:2212.04356].

Port of the JAX package's ``models/whisper.py``. The conv frontend is a
stub: the inputs are precomputed mel-frame embeddings (B, n_audio_ctx,
d_model). Encoder: bidirectional pre-LN MHA with sinusoidal positions.
Decoder: causal self-attention + cross-attention to the encoder output,
learned positions, output head tied to the embedding.

With ``cfg.use_kernels`` every prefill attention is one flash launch: the
encoder's non-causal self-attention over n_audio_ctx frames, the
decoder's causal self-attention, and its non-causal cross-attention (Tq =
prompt, Tk = n_audio_ctx). ``decode_step`` attends to both caches in plain
torch and launches no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import common
from repro_torch.models.transformer import _apply_norm, _norm_defs, embed, layer, write_at
from repro_torch.nn.module import (Param, init_tree, nest, pspec_tree, spec_tree,
                                   stack_defs)


def _mha_defs(cfg: ArchConfig):
    dm, hd, nh = cfg.d_model, cfg.head_dim, cfg.n_heads
    dt = cfg.dtype
    return {
        "wq": Param((dm, nh * hd), dt, "fan_in", ("embed", "heads")),
        "wk": Param((dm, nh * hd), dt, "fan_in", ("embed", "heads")),
        "wv": Param((dm, nh * hd), dt, "fan_in", ("embed", "heads")),
        "wo": Param((nh * hd, dm), dt, "fan_in", ("heads", "embed")),
        "bq": Param((nh * hd,), dt, "zeros", ("heads",)),
        "bv": Param((nh * hd,), dt, "zeros", ("heads",)),
        "bo": Param((dm,), dt, "zeros", (None,)),
    }


def _mha_project(cfg, p, xq, xkv):
    b, tq, _ = xq.shape
    tk = xkv.shape[1]
    nh, hd = cfg.n_heads, cfg.head_dim
    q = (xq @ p["wq"] + p["bq"]).reshape(b, tq, nh, hd)
    k = (xkv @ p["wk"]).reshape(b, tk, nh, hd)
    v = (xkv @ p["wv"] + p["bv"]).reshape(b, tk, nh, hd)
    return q, k, v


def _mha(cfg, p, xq, xkv, causal):
    b, tq, _ = xq.shape
    q, k, v = _mha_project(cfg, p, xq, xkv)
    o = common.attention(q, k, v, causal=causal, use_kernels=cfg.use_kernels)
    return o.reshape(b, tq, -1) @ p["wo"] + p["bo"], (k, v)


def _ffn_defs(cfg: ArchConfig):
    dm, df, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        "w1": Param((dm, df), dt, "fan_in", ("embed", "mlp")),
        "b1": Param((df,), dt, "zeros", ("mlp",)),
        "w2": Param((df, dm), dt, "fan_in", ("mlp", "embed")),
        "b2": Param((dm,), dt, "zeros", (None,)),
    }


def _ffn(p, x):
    return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]


class Whisper:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # ---- defs -----------------------------------------------------------
    def _enc_layer_defs(self):
        cfg = self.cfg
        return {"ln1": _norm_defs(cfg), "attn": _mha_defs(cfg),
                "ln2": _norm_defs(cfg), "ffn": _ffn_defs(cfg)}

    def _dec_layer_defs(self):
        cfg = self.cfg
        return {"ln1": _norm_defs(cfg), "self_attn": _mha_defs(cfg),
                "ln2": _norm_defs(cfg), "cross_attn": _mha_defs(cfg),
                "ln3": _norm_defs(cfg), "ffn": _ffn_defs(cfg)}

    @property
    def defs(self):
        cfg = self.cfg
        return {
            "embed": Param((cfg.vocab, cfg.d_model), cfg.dtype, "normal_0.02",
                           (None, "embed_shard")),
            # sized to cover the decode_32k cell (learned positions)
            "pos_dec": Param((32768 + 1024, cfg.d_model), cfg.dtype,
                             "normal_0.02", (None, None)),
            "enc_layers": stack_defs(self._enc_layer_defs(), cfg.n_encoder_layers),
            "dec_layers": stack_defs(self._dec_layer_defs(), cfg.n_layers),
            "ln_enc": _norm_defs(cfg),
            "ln_dec": _norm_defs(cfg),
        }

    def init(self, seed: int = 0, device: DeviceLike = None) -> dict[str, torch.Tensor]:
        return init_tree(self.defs, seed, device)

    def specs(self) -> dict[str, torch.Tensor]:
        return spec_tree(self.defs)

    def pspecs(self, rules) -> dict:
        return pspec_tree(self.defs, rules)

    # ---- encoder ----------------------------------------------------------
    def _encode(self, params, frames):
        cfg = self.cfg
        t = frames.shape[1]
        pos = torch.from_numpy(common.sinusoidal_positions(t, cfg.d_model)).to(
            device=frames.device, dtype=cfg.dtype)
        x = frames.to(cfg.dtype) + pos[None]
        for i in range(cfg.n_encoder_layers):
            p = layer(params["enc_layers"], i)
            normed = _apply_norm(cfg, p["ln1"], x)
            h, _ = _mha(cfg, p["attn"], normed, normed, causal=False)
            x = x + h
            x = x + _ffn(p["ffn"], _apply_norm(cfg, p["ln2"], x))
        return _apply_norm(cfg, params["ln_enc"], x)

    @torch.no_grad()
    def encode(self, params, frames):
        """frames: (B, n_audio_ctx, d_model) stub embeddings."""
        return self._encode(nest(params), frames)

    # ---- decoder ------------------------------------------------------------
    def _dec_block(self, p, x, enc):
        cfg = self.cfg
        normed = _apply_norm(cfg, p["ln1"], x)
        h, self_kv = _mha(cfg, p["self_attn"], normed, normed, causal=True)
        x = x + h
        h, cross_kv = _mha(cfg, p["cross_attn"], _apply_norm(cfg, p["ln2"], x),
                           enc, causal=False)
        x = x + h
        x = x + _ffn(p["ffn"], _apply_norm(cfg, p["ln3"], x))
        return x, self_kv, cross_kv

    def _decoder(self, params, tokens, enc, collect_kv=True):
        """(normed decoder states, [(self k, v)], [(cross k, v)]). Without
        ``collect_kv`` (the loss) each block runs under ``cfg.remat`` (any
        mode other than "none" keeps nothing, as the reference) and the
        lists stay empty."""
        cfg = self.cfg
        t = tokens.shape[1]
        x = embed(params["embed"], tokens) + params["pos_dec"][:t][None]
        selfs, crosses = [], []
        block = common.remat(lambda p, x, enc: self._dec_block(p, x, enc)[0],
                             "none" if cfg.remat == "none" else "full")
        for i in range(cfg.n_layers):
            p = layer(params["dec_layers"], i)
            if not collect_kv:
                x = block(p, x, enc)
                continue
            x, self_kv, cross_kv = self._dec_block(p, x, enc)
            selfs.append(self_kv)
            crosses.append(cross_kv)
        return _apply_norm(cfg, params["ln_dec"], x), selfs, crosses

    # ---- public ----------------------------------------------------------------
    def loss(self, params, batch):
        """batch: frames (B, n_ctx, d_model), tokens (B,T), labels (B,T).
        Differentiable; the decoder blocks under ``cfg.remat``."""
        params = nest(params)
        enc = self._encode(params, batch["frames"])
        x, _, _ = self._decoder(params, batch["tokens"], enc, collect_kv=False)
        # tied output head (whisper ties embed <-> logits)
        return common.cross_entropy(x @ params["embed"].T, batch["labels"])

    @torch.no_grad()
    def prefill(self, params, batch, max_len=None):
        cfg = self.cfg
        params = nest(params)
        enc = self._encode(params, batch["frames"])
        tokens = batch["tokens"]
        b, t = tokens.shape
        x, selfs, crosses = self._decoder(params, tokens, enc)
        logits = x[:, -1:] @ params["embed"].T
        cache_len = max(max_len or t + 64, t)
        cache = {}
        for name, i in (("k", 0), ("v", 1)):
            c = torch.zeros((cfg.n_layers, b, cache_len, cfg.n_heads, cfg.head_dim),
                            dtype=selfs[0][i].dtype, device=x.device)
            for layer_i, kv in enumerate(selfs):
                c[layer_i, :, :t] = kv[i]
            cache[name] = c
        cache["ck"] = torch.stack([kv[0] for kv in crosses])
        cache["cv"] = torch.stack([kv[1] for kv in crosses])
        cache["len"] = torch.tensor(t, dtype=torch.int32, device=tokens.device)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """One token; the self-attention cache is written in place."""
        cfg = self.cfg
        params = nest(params)
        b = tokens.shape[0]
        clen = cache["len"]
        x = embed(params["embed"], tokens)
        x = x + params["pos_dec"].index_select(0, clen.reshape(1).long())[None]
        nh, hd = cfg.n_heads, cfg.head_dim
        for i in range(cfg.n_layers):
            p = layer(params["dec_layers"], i)
            k_c, v_c, ck, cv = (cache[n][i] for n in ("k", "v", "ck", "cv"))
            normed = _apply_norm(cfg, p["ln1"], x)
            q, k, v = _mha_project(cfg, p["self_attn"], normed, normed)
            write_at(k_c, clen, k)
            write_at(v_c, clen, v)
            o = common.decode_attention(q, k_c, v_c, clen + 1)
            x = x + o.reshape(b, 1, -1) @ p["self_attn"]["wo"] + p["self_attn"]["bo"]
            # cross attention against the precomputed encoder KV
            normed = _apply_norm(cfg, p["ln2"], x)
            q = (normed @ p["cross_attn"]["wq"] + p["cross_attn"]["bq"]).reshape(
                b, 1, nh, hd)
            o = common.decode_attention(q, ck, cv, ck.shape[1])
            x = x + o.reshape(b, 1, -1) @ p["cross_attn"]["wo"] + p["cross_attn"]["bo"]
            x = x + _ffn(p["ffn"], _apply_norm(cfg, p["ln3"], x))
        logits = _apply_norm(cfg, params["ln_dec"], x) @ params["embed"].T
        return logits, dict(cache, len=clen + 1)

    def cache_specs(self, batch: int, max_len: int):
        cfg = self.cfg
        l, nh, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        return {
            "k": meta((l, batch, max_len, nh, hd), cfg.dtype),
            "v": meta((l, batch, max_len, nh, hd), cfg.dtype),
            "ck": meta((l, batch, cfg.n_audio_ctx, nh, hd), cfg.dtype),
            "cv": meta((l, batch, cfg.n_audio_ctx, nh, hd), cfg.dtype),
            "len": meta((), torch.int32),
        }
