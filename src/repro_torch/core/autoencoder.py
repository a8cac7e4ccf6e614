"""3D convolutional block autoencoder (paper Fig. 1).

Input instances are (NB, S, bt, ph, pw) spatiotemporal blocks; species are
the conv channel axis. Encoder: Conv3d stack (LeakyReLU) -> one dense layer
to a 36-dim latent. Decoder mirrors it with a dense layer and a stack of
stride-1 transposed convolutions back to S channels.

The public layout is the reference's: blocks are (NB, S, bt, ph, pw), which
already is PyTorch's channels-first order, so no transpose is needed around
the convolutions. The reference runs them channels-last and flattens
(bt, ph, pw, C) into the dense layers; the same permutation is applied here
before ``enc_fc`` and after ``dec_fc`` so dense weights carry across
unchanged (see :mod:`repro_torch.convert`).

``decode``/``encode`` take an optional flat parameter dict; the codec's
decode runtime passes the parameters that arrived in a container.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import layers as L
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop


@dataclasses.dataclass(frozen=True)
class AEConfig:
    n_species: int
    block: tuple[int, int, int]  # (bt, ph, pw)
    latent: int = 36
    conv_channels: tuple[int, ...] = (64, 128)
    negative_slope: float = 0.2


class BlockAutoencoder(nn.Module):
    def __init__(self, cfg: AEConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        bt, ph, pw = cfg.block
        chans = (cfg.n_species,) + tuple(cfg.conv_channels)
        self.n_convs = len(cfg.conv_channels)
        self.flat = cfg.conv_channels[-1] * bt * ph * pw
        kw = dict(generator=generator, device=device)
        # construction order is the reference's sorted-path leaf order, so
        # one generator state maps to one well-defined set of draws
        rev = tuple(reversed(chans))
        for i in range(self.n_convs):
            setattr(self, f"dec_conv{i}",
                    L.Conv3dTranspose(rev[i], rev[i + 1], **kw))
        self.dec_fc = L.Dense(cfg.latent, self.flat, **kw)
        for i in range(self.n_convs):
            setattr(self, f"enc_conv{i}", L.Conv3d(chans[i], chans[i + 1], **kw))
        self.enc_fc = L.Dense(self.flat, cfg.latent, **kw)

    # ---- parameter views -------------------------------------------------
    def params(self) -> dict[str, torch.Tensor]:
        """Flat name -> tensor dict of all parameters (detached views)."""
        return {k: p.detach() for k, p in self.named_parameters()}

    @property
    def defs(self) -> dict:
        """Reference-layout shape tree (``{layer: {"w": shape, "b": shape}}``),
        what the wire's parameter streams are cut by."""
        chans = (self.cfg.n_species,) + tuple(self.cfg.conv_channels)
        rev = tuple(reversed(chans))
        d = {
            "enc_fc": {"w": (self.flat, self.cfg.latent),
                       "b": (self.cfg.latent,)},
            "dec_fc": {"w": (self.cfg.latent, self.flat), "b": (self.flat,)},
        }
        for i in range(self.n_convs):
            d[f"enc_conv{i}"] = {"w": (3, 3, 3, chans[i], chans[i + 1]),
                                 "b": (chans[i + 1],)}
            d[f"dec_conv{i}"] = {"w": (3, 3, 3, rev[i], rev[i + 1]),
                                 "b": (rev[i + 1],)}
        return d

    def _p(self, params):
        return dict(self.named_parameters()) if params is None else params

    # ---- forward ---------------------------------------------------------
    def encode(self, x: torch.Tensor, params=None) -> torch.Tensor:
        p = self._p(params)
        slope = self.cfg.negative_slope
        h = x  # (NB, S, bt, ph, pw): channels first already
        for i in range(self.n_convs):
            h = L.leaky_relu(
                L.conv3d(h, p[f"enc_conv{i}.weight"], p[f"enc_conv{i}.bias"]),
                slope)
        # the reference flattens channels-last: (bt, ph, pw, C)
        h = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)
        return L.dense(h, p["enc_fc.weight"], p["enc_fc.bias"])

    def decode(self, z: torch.Tensor, params=None) -> torch.Tensor:
        p = self._p(params)
        slope = self.cfg.negative_slope
        bt, ph, pw = self.cfg.block
        c_last = self.cfg.conv_channels[-1]
        h = L.leaky_relu(L.dense(z, p["dec_fc.weight"], p["dec_fc.bias"]), slope)
        h = h.reshape(-1, bt, ph, pw, c_last).permute(0, 4, 1, 2, 3)
        for i in range(self.n_convs):
            h = L.conv3d_transpose(h, p[f"dec_conv{i}.weight"],
                                   p[f"dec_conv{i}.bias"])
            if i < self.n_convs - 1:
                h = L.leaky_relu(h, slope)
        return h  # (NB, S, bt, ph, pw)

    def forward(self, x: torch.Tensor, params=None) -> torch.Tensor:
        return self.decode(self.encode(x, params), params)


def ae_loss(model: BlockAutoencoder):
    def loss_fn(p, batch):
        rec = model(batch, p)
        return torch.mean(torch.square(rec - batch))

    return loss_fn


def init_params(cfg: AEConfig, seed: int, device=None) -> dict[str, torch.Tensor]:
    """Fresh parameters from a seeded generator (the reference's init laws,
    this package's own numbers)."""
    g = torch.Generator().manual_seed(int(seed))
    return BlockAutoencoder(cfg, generator=g, device=device).params()


def fit(
    model: BlockAutoencoder,
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
    """Train the AE with AdamW on MSE. Returns ``(params, loss_history)``;
    ``params`` starts the run from given parameters instead of a fresh
    seeded init, ``indices`` feeds a ``(steps, batch)`` index matrix
    instead of the trainer's own draws, ``mesh`` runs the data-parallel fit
    (:meth:`~repro_torch.train.train_loop.MiniBatchTrainer.fit`)."""
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    if params is None:
        params = init_params(model.cfg, seed, dev)
    trainer = train_loop.MiniBatchTrainer(
        ae_loss(model), opt.adamw_cfg(lr, steps),
        log_fn=lambda t, loss: print(f"[ae] step {t} loss {loss:.3e}"),
    )
    return trainer.fit(
        params, (blocks,), steps=steps, batch_size=batch_size, seed=seed,
        log_every=log_every, indices=indices, device=dev,
        mesh=mesh,
    )
