"""Logical meshes for the sharding rules and the dry run.

The counterpart of the JAX package's ``launch/mesh.py``. There a mesh is
``jax.make_mesh`` over devices (512 forced host devices for the dry run).
This package has no partitioner, so what the rules and the dry run need of
a mesh is its axis names and sizes, as ``jax.sharding.AbstractMesh`` gives
them: a :class:`LogicalMesh` holds only those, with ``.shape`` (name ->
size) and ``.axis_names``. Building one touches no device, and importing
this module touches none either.

It is not :class:`repro_torch.parallel.Mesh`: that one is an ordered tuple
of real devices along the one data axis, on which the sharded fit and
compress run. A logical mesh places nothing; it is what per-device bytes
are counted against (:mod:`repro_torch.parallel.sharding`).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes, outermost first; no devices."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        sizes = tuple(int(n) for n in self.sizes)
        names = tuple(self.axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {sizes} and axes {names} do not pair up")
        if any(n < 1 for n in sizes):
            raise ValueError(f"mesh axis sizes must be positive: {sizes}")
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """16 x 16 = 256 devices as ("data", "model"); multi-pod (2, 16, 16) =
    512 as ("pod", "data", "model")."""
    if multi_pod:
        return LogicalMesh((2, 16, 16), ("pod", "data", "model"))
    return LogicalMesh((16, 16), ("data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> LogicalMesh:
    """Any mesh, e.g. (4, 2) over ("data", "model") or (1, 1) for one card."""
    return LogicalMesh(tuple(shape), tuple(axes))
