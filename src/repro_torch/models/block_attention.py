"""Patch-token block attention encoder/decoder (the second GBATC family).

Port of the JAX package's ``models/block_attention.py``: the paper group's
follow-up that replaces the conv block autoencoder with attention over the
same block instances. An (NB, S, bt, ph, pw) block flattens to ``S * bt``
patch tokens of dimension ``ph * pw``; a dense projection plus fixed
sinusoidal positions lifts them to ``d_model``; ``depth`` pre-norm
non-causal transformer blocks (multi-head attention + SwiGLU) mix them;
one dense layer maps the flattened token grid to the latent. The decoder
mirrors it, and the codec stores its ``dec``-prefixed parameters only.

Parameters are flat ``state_dict``-style names of the reference's tree
(``enc_block0.attn.wq``, ``enc_proj.weight``, ``dec_norm.scale``), with
2-D weights in PyTorch's (out, in) layout; :mod:`repro_torch.convert`
carries them across. They are fp32, the reference's default and the only
dtype the codec uses.

``attn_impl`` selects the attention: ``"direct"`` runs
:func:`repro_torch.models.common.attention`, which is differentiable;
``"flash"`` runs :func:`repro_torch.kernels.ops.flash_attention`, the
hand-written kernel on a CUDA device (its plain version on the CPU), which
has no backward. The codec builds the model with ``"flash"`` for every
forward pass without gradients, and :func:`fit` trains through
``"direct"`` on the same parameters, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.nn import layers as L
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop

ATTN_IMPLS = ("direct", "flash")


@dataclasses.dataclass(frozen=True)
class BlockAttentionConfig:
    n_species: int
    block: tuple[int, int, int]  # (bt, ph, pw)
    latent: int = 36
    d_model: int = 32
    n_heads: int = 2
    depth: int = 1
    mlp_hidden: int = 64
    attn_impl: str = "direct"  # "direct" | "flash" (the CUDA kernel)

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads "
                f"{self.n_heads}"
            )
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl {self.attn_impl!r} is not one of {ATTN_IMPLS}")

    @property
    def n_tokens(self) -> int:
        return self.n_species * self.block[0]

    @property
    def token_dim(self) -> int:
        return self.block[1] * self.block[2]

    @property
    def arch(self) -> tuple[int, int, int, int]:
        """The wire arch words (see ``codec.families``)."""
        return (self.d_model, self.n_heads, self.depth, self.mlp_hidden)


class _Norm(nn.Module):
    def __init__(self, dim: int, *, device=None, **_):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))


class _Attn(nn.Module):
    def __init__(self, dm: int, *, generator=None, device=None):
        super().__init__()
        # sorted leaf order, as the reference's tree walks it
        for name in ("wk", "wo", "wq", "wv"):
            setattr(self, name, nn.Parameter(
                L.normal_fan_in((dm, dm), dm, generator, device)))


class _FFN(nn.Module):
    def __init__(self, dm: int, df: int, *, generator=None, device=None):
        super().__init__()
        self.wd = nn.Parameter(L.normal_fan_in((dm, df), df, generator, device))
        self.wg = nn.Parameter(L.normal_fan_in((df, dm), dm, generator, device))
        self.wu = nn.Parameter(L.normal_fan_in((df, dm), dm, generator, device))


class _Block(nn.Module):
    def __init__(self, cfg: BlockAttentionConfig, **kw):
        super().__init__()
        self.attn = _Attn(cfg.d_model, **kw)
        self.ffn = _FFN(cfg.d_model, cfg.mlp_hidden, **kw)
        self.ln1 = _Norm(cfg.d_model, **kw)
        self.ln2 = _Norm(cfg.d_model, **kw)


def _rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale).to(x.dtype)


class BlockAttentionAE(nn.Module):
    """Encoder/decoder over (NB, S, bt, ph, pw) blocks; same contract as
    :class:`repro_torch.core.autoencoder.BlockAutoencoder` (``encode(x,
    params)``, ``decode(z, params)``, ``defs`` with ``enc``/``dec`` key
    prefixes)."""

    def __init__(self, cfg: BlockAttentionConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        dm, td, nt = cfg.d_model, cfg.token_dim, cfg.n_tokens
        kw = dict(generator=generator, device=device)
        make = {
            "enc_proj": lambda: L.Dense(td, dm, **kw),
            "enc_head": lambda: L.Dense(nt * dm, cfg.latent, **kw),
            "enc_norm": lambda: _Norm(dm, **kw),
            "dec_proj": lambda: L.Dense(cfg.latent, nt * dm, **kw),
            "dec_head": lambda: L.Dense(dm, td, **kw),
            "dec_norm": lambda: _Norm(dm, **kw),
        }
        for i in range(cfg.depth):
            make[f"enc_block{i}"] = make[f"dec_block{i}"] = \
                lambda: _Block(cfg, **kw)
        # construction order is the reference's sorted-path leaf order, so
        # one generator state maps to one well-defined set of draws
        for name in sorted(make):
            setattr(self, name, make[name]())
        # fixed (not learned) positions: static per structural config, so
        # they need no bytes on the wire
        self.register_buffer(
            "pos", torch.from_numpy(common.sinusoidal_positions(nt, dm)).to(device),
            persistent=False)

    # ---- parameter views -------------------------------------------------
    def params(self) -> dict[str, torch.Tensor]:
        """Flat name -> tensor dict of all parameters (detached views)."""
        return {k: p.detach() for k, p in self.named_parameters()}

    @property
    def defs(self) -> dict:
        """Reference-layout shape tree, what the wire's parameter streams
        are cut by."""
        cfg = self.cfg
        dm, df, td, nt = cfg.d_model, cfg.mlp_hidden, cfg.token_dim, cfg.n_tokens
        block = {
            "ln1": {"scale": (dm,)},
            "attn": {n: (dm, dm) for n in ("wq", "wk", "wv", "wo")},
            "ln2": {"scale": (dm,)},
            "ffn": {"wg": (dm, df), "wu": (dm, df), "wd": (df, dm)},
        }
        d: dict = {
            "enc_proj": {"w": (td, dm), "b": (dm,)},
            "enc_head": {"w": (nt * dm, cfg.latent), "b": (cfg.latent,)},
            "enc_norm": {"scale": (dm,)},
            "dec_proj": {"w": (cfg.latent, nt * dm), "b": (nt * dm,)},
            "dec_head": {"w": (dm, td), "b": (td,)},
            "dec_norm": {"scale": (dm,)},
        }
        for i in range(cfg.depth):
            d[f"enc_block{i}"] = block
            d[f"dec_block{i}"] = block
        return d

    def _p(self, params):
        return dict(self.named_parameters()) if params is None else params

    # ---- forward ---------------------------------------------------------
    def _attention(self, p, pre: str, x: torch.Tensor, impl: str):
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.d_model // cfg.n_heads
        q = F.linear(x, p[pre + "wq"]).reshape(b, t, cfg.n_heads, hd)
        k = F.linear(x, p[pre + "wk"]).reshape(b, t, cfg.n_heads, hd)
        v = F.linear(x, p[pre + "wv"]).reshape(b, t, cfg.n_heads, hd)
        if impl == "flash":
            o = ops.flash_attention(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), causal=False, device=x.device,
            ).transpose(1, 2)
        else:
            o = common.attention(q, k, v, causal=False)
        return F.linear(o.reshape(b, t, -1), p[pre + "wo"])

    def _block(self, p, pre: str, x: torch.Tensor, impl: str):
        x = x + self._attention(p, pre + "attn.",
                                _rms_norm(p[pre + "ln1.scale"], x), impl)
        h = _rms_norm(p[pre + "ln2.scale"], x)
        return x + F.linear(
            F.silu(F.linear(h, p[pre + "ffn.wg"])) * F.linear(h, p[pre + "ffn.wu"]),
            p[pre + "ffn.wd"])

    def encode(self, x: torch.Tensor, params=None,
               attn_impl: Optional[str] = None) -> torch.Tensor:
        cfg, p = self.cfg, self._p(params)
        impl = attn_impl or cfg.attn_impl
        h = x.reshape(x.shape[0], cfg.n_tokens, cfg.token_dim)
        h = L.dense(h, p["enc_proj.weight"], p["enc_proj.bias"]) + self.pos
        for i in range(cfg.depth):
            h = self._block(p, f"enc_block{i}.", h, impl)
        h = _rms_norm(p["enc_norm.scale"], h)
        return L.dense(h.reshape(h.shape[0], -1), p["enc_head.weight"],
                       p["enc_head.bias"])

    def decode(self, z: torch.Tensor, params=None,
               attn_impl: Optional[str] = None) -> torch.Tensor:
        cfg, p = self.cfg, self._p(params)
        impl = attn_impl or cfg.attn_impl
        s, (bt, ph, pw) = cfg.n_species, cfg.block
        h = L.dense(z, p["dec_proj.weight"], p["dec_proj.bias"])
        h = h.reshape(-1, cfg.n_tokens, cfg.d_model) + self.pos
        for i in range(cfg.depth):
            h = self._block(p, f"dec_block{i}.", h, impl)
        h = _rms_norm(p["dec_norm.scale"], h)
        h = L.dense(h, p["dec_head.weight"], p["dec_head.bias"])
        return h.reshape(-1, s, bt, ph, pw)

    def forward(self, x: torch.Tensor, params=None,
                attn_impl: Optional[str] = None) -> torch.Tensor:
        return self.decode(self.encode(x, params, attn_impl), params, attn_impl)


def ae_loss(model: BlockAttentionAE, attn_impl: str = "direct"):
    """Mean squared reconstruction error, through the differentiable
    attention unless asked otherwise."""
    def loss_fn(p, batch):
        rec = model(batch, p, attn_impl)
        return torch.mean(torch.square(rec - batch))

    return loss_fn


def init_params(cfg: BlockAttentionConfig, seed: int,
                device=None) -> dict[str, torch.Tensor]:
    """Fresh parameters from a seeded generator (the reference's init laws,
    this package's own numbers)."""
    g = torch.Generator().manual_seed(int(seed))
    return BlockAttentionAE(cfg, generator=g, device=device).params()


def fit(
    model: BlockAttentionAE,
    blocks,
    *,
    steps: int = 400,
    batch_size: int = 64,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 0,
    params: Optional[dict] = None,
    indices=None,
    device: DeviceLike = None,
    mesh=None,
) -> tuple[dict[str, torch.Tensor], np.ndarray]:
    """Train with AdamW on MSE through the direct attention — the
    :func:`repro_torch.core.autoencoder.fit` contract, so the pipeline's
    family handle calls either alike. Returns ``(params, loss_history)``."""
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    if params is None:
        params = init_params(model.cfg, seed, dev)
    trainer = train_loop.MiniBatchTrainer(
        ae_loss(model), opt.adamw_cfg(lr, steps),
        log_fn=lambda t, loss: print(f"[attn] step {t} loss {loss:.3e}"),
    )
    return trainer.fit(
        params, (blocks,), steps=steps, batch_size=batch_size, seed=seed,
        log_every=log_every, indices=indices, device=dev,
        mesh=mesh,
    )
