"""Mesh plumbing: the data axis the sharded fit and compress run over.

Counterpart of the mesh helpers of the JAX package's
``parallel/mesh_fit.py``. The reference's mesh is a 1-D ``("data",)``
mesh over devices driven by one process; so is this one. A
:class:`Mesh` is an ordered tuple of ``torch.device`` along the data axis,
and one host thread places row shards and launches work on each of them.

A mesh may name one device more than once: ``Mesh(("cpu",) * 4)`` in the
tests, or ``Mesh(("cuda:0",) * 4)`` on a one-card machine. That is this
package's counterpart of ``--xla_force_host_platform_device_count``, which
the reference's CI runs on: every ``P > 1`` branch runs, each shard in its
own tensors, on the devices there are. Multi-process and multi-node runs
(``torch.distributed``) are not part of this package; the reference has no
multi-host path either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

#: the one mesh axis (batch rows, block rows, species) this package shards over
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along the data axis; shard ``i`` lives on
    ``devices[i]``. Device-likes are resolved (``"cuda"`` -> the current
    card), and a device may repeat."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def host_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (default: all);
    raises ``ValueError`` when fewer exist, as the reference does."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = avail if n_devices is None else int(n_devices)
    if not 1 <= n <= avail:
        raise ValueError(f"host_mesh wants {n} devices but {avail} are available")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def mesh_size(mesh: Mesh) -> int:
    return mesh.size


def mesh_cache_key(mesh: Mesh) -> tuple:
    """Hashable identity for caches: the devices, in order."""
    return tuple(str(d) for d in mesh.devices)


def as_tensor(a, device: DeviceLike = None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` (no copy when it
    already lives there)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a if device is None else a.to(device)


def shard_rows(array, mesh: Mesh) -> list[torch.Tensor]:
    """Split rows (the leading axis) into ``mesh.size`` contiguous equal
    ranges, shard ``i`` on ``mesh.devices[i]``, as ``P("data")`` places
    them. Each shard is a copy of its own, also where devices repeat or
    the array already lives on the device."""
    t = as_tensor(array)
    p = mesh.size
    if t.shape[0] % p:
        raise ValueError(
            f"{t.shape[0]} rows do not divide the mesh size {p}")
    per = t.shape[0] // p
    return [t[i * per:(i + 1) * per].to(dev, copy=True)
            for i, dev in enumerate(mesh.devices)]


def gather_rows(shards: Sequence[torch.Tensor], r0: int, r1: int,
                device: DeviceLike) -> torch.Tensor:
    """Global rows ``[r0, r1)`` of equal row shards, on ``device`` (the
    pieces of the shards the range crosses, in order)."""
    per = shards[0].shape[0]
    pieces = [
        s[max(r0 - i * per, 0):min(r1 - i * per, per)].to(device)
        for i, s in enumerate(shards)
        if i * per < r1 and (i + 1) * per > r0
    ]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)
