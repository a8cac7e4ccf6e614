"""Tensor correction network (paper §II-C).

A *pointwise* (per temporal/spatial sample) over-complete MLP that maps the
S reconstructed species values back toward the originals:
S -> 4S -> 8S -> 4S -> S with LeakyReLU (paper: 58->232->464->232->58),
parameterised residually (out = x_rec + mlp(x_rec)) as in the reference.
No new latents are stored — only the network parameters.
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
class CorrectionConfig:
    n_species: int
    widths: tuple[int, int, int] = (4, 8, 4)  # multiples of S
    negative_slope: float = 0.2


class TensorCorrectionNetwork(nn.Module):
    def __init__(self, cfg: CorrectionConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        s = cfg.n_species
        self.dims = (s,) + tuple(w * s for w in cfg.widths) + (s,)
        self.n_fcs = len(self.dims) - 1
        for i in range(self.n_fcs):
            setattr(self, f"fc{i}",
                    L.Dense(self.dims[i], self.dims[i + 1],
                            generator=generator, device=device))

    def params(self) -> dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.named_parameters()}

    @property
    def defs(self) -> dict:
        """Reference-layout shape tree of the wire's correction stream."""
        return {
            f"fc{i}": {"w": (self.dims[i], self.dims[i + 1]),
                       "b": (self.dims[i + 1],)}
            for i in range(self.n_fcs)
        }

    def forward(self, x_rec: torch.Tensor, params=None) -> torch.Tensor:
        """x_rec: (..., S) pointwise species vectors; returns corrected (..., S)."""
        p = dict(self.named_parameters()) if params is None else params
        h = x_rec
        for i in range(self.n_fcs):
            h = L.dense(h, p[f"fc{i}.weight"], p[f"fc{i}.bias"])
            if i < self.n_fcs - 1:
                h = L.leaky_relu(h, self.cfg.negative_slope)
        return x_rec + h


def blocks_to_pointwise(blocks):
    """(NB, S, bt, ph, pw) -> (NB*bt*ph*pw, S) species vectors (numpy or
    torch in, same kind out)."""
    nb, s = blocks.shape[:2]
    if isinstance(blocks, torch.Tensor):
        return blocks.reshape(nb, s, -1).permute(0, 2, 1).reshape(-1, s).contiguous()
    return np.ascontiguousarray(
        blocks.reshape(nb, s, -1).transpose(0, 2, 1).reshape(-1, s)
    )


def pointwise_to_blocks(vecs, like):
    nb, s, bt, ph, pw = like.shape
    if isinstance(vecs, torch.Tensor):
        return (vecs.reshape(nb, bt * ph * pw, s).permute(0, 2, 1)
                .reshape(nb, s, bt, ph, pw).contiguous())
    return np.ascontiguousarray(
        vecs.reshape(nb, bt * ph * pw, s).transpose(0, 2, 1).reshape(nb, s, bt, ph, pw)
    )


def corr_loss(net: TensorCorrectionNetwork):
    def loss_fn(p, a, b):
        return torch.mean(torch.square(net(a, p) - b))

    return loss_fn


def init_params(cfg: CorrectionConfig, seed: int, device=None):
    g = torch.Generator().manual_seed(int(seed))
    return TensorCorrectionNetwork(cfg, generator=g, device=device).params()


def fit(
    net: TensorCorrectionNetwork,
    x_rec,
    x_orig,
    *,
    steps: int = 300,
    batch_size: int = 4096,
    lr: float = 1e-3,
    seed: int = 1,
    log_every: int = 0,
    params: Optional[dict] = None,
    indices=None,
    device: DeviceLike = None,
    mesh=None,
) -> tuple[dict[str, torch.Tensor], np.ndarray]:
    """Train the correction net on (reconstructed -> original) species
    vectors. Returns ``(params, loss_history)``; ``mesh`` runs the
    data-parallel fit (:meth:`~repro_torch.train.train_loop.
    MiniBatchTrainer.fit`)."""
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    if params is None:
        params = init_params(net.cfg, seed, dev)
    trainer = train_loop.MiniBatchTrainer(
        corr_loss(net), opt.adamw_cfg(lr, steps),
        log_fn=lambda t, loss: print(f"[corr] step {t} loss {loss:.3e}"),
    )
    return trainer.fit(
        params, (x_rec, x_orig), steps=steps, batch_size=batch_size,
        seed=seed, log_every=log_every, indices=indices, device=dev,
        mesh=mesh,
    )
