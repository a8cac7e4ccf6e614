"""Spatiotemporal blocking (paper §II-B).

The S3D field is a (S, T, H, W) array: S species (tensor axis), T time steps,
H x W spatial grid. Per species we partition each frame into non-overlapping
``ph x pw`` patches and group ``bt`` consecutive time steps of the same patch
location into one block. Paper geometry: bt=4 timesteps, 5x4 patches -> 80
scalars per species per block; an AE instance is the (S, bt, ph, pw) stack
across all species at one (time-group, location).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    bt: int  # time steps per block
    ph: int  # patch height
    pw: int  # patch width

    @property
    def block_size(self) -> int:
        return self.bt * self.ph * self.pw


PAPER_GEOMETRY = BlockGeometry(bt=4, ph=5, pw=4)


def check_divisible(shape: tuple[int, int, int, int], geom: BlockGeometry) -> None:
    s, t, h, w = shape
    if t % geom.bt or h % geom.ph or w % geom.pw:
        raise ValueError(
            f"data shape {shape} not divisible by block geometry "
            f"(bt={geom.bt}, ph={geom.ph}, pw={geom.pw})"
        )


def to_blocks(data: np.ndarray, geom: BlockGeometry) -> np.ndarray:
    """(S, T, H, W) -> (NB, S, bt, ph, pw) with NB = (T/bt)(H/ph)(W/pw).

    Block index runs (time-group, patch-row, patch-col) row-major, so the
    inverse is a pure reshape/transpose — bit-exact round trip.
    """
    check_divisible(data.shape, geom)
    s, t, h, w = data.shape
    nt, nh, nw = t // geom.bt, h // geom.ph, w // geom.pw
    x = data.reshape(s, nt, geom.bt, nh, geom.ph, nw, geom.pw)
    # -> (nt, nh, nw, s, bt, ph, pw)
    x = x.transpose(1, 3, 5, 0, 2, 4, 6)
    return np.ascontiguousarray(x.reshape(nt * nh * nw, s, geom.bt, geom.ph, geom.pw))


def from_blocks(
    blocks: np.ndarray, shape: tuple[int, int, int, int], geom: BlockGeometry
) -> np.ndarray:
    """Inverse of :func:`to_blocks`."""
    s, t, h, w = shape
    nt, nh, nw = t // geom.bt, h // geom.ph, w // geom.pw
    x = blocks.reshape(nt, nh, nw, s, geom.bt, geom.ph, geom.pw)
    x = x.transpose(3, 0, 4, 1, 5, 2, 6)  # (s, nt, bt, nh, ph, nw, pw)
    return np.ascontiguousarray(x.reshape(s, t, h, w))


def blocks_as_vectors(blocks: np.ndarray) -> np.ndarray:
    """(NB, S, bt, ph, pw) -> per-species block vectors (S, NB, D)."""
    nb, s = blocks.shape[:2]
    return np.ascontiguousarray(
        blocks.reshape(nb, s, -1).transpose(1, 0, 2)
    )


def vectors_as_blocks(vecs: np.ndarray, geom: BlockGeometry) -> np.ndarray:
    """(S, NB, D) -> (NB, S, bt, ph, pw)."""
    s, nb, d = vecs.shape
    assert d == geom.block_size
    return np.ascontiguousarray(
        vecs.transpose(1, 0, 2).reshape(nb, s, geom.bt, geom.ph, geom.pw)
    )
