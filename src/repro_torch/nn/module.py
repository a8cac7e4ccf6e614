"""Parameter definitions of the language models: the counterpart of the JAX
package's ``nn/module.py`` (``Param``, ``init_tree``, ``spec_tree``,
``logical_to_pspec``, ``pspec_tree``).

A model describes its parameters as a nested-dict *definition tree* whose
leaves are :class:`Param` — shape, dtype, initializer and logical axis
names — under the reference's paths, stacked layer axes included
(:func:`stack_defs`, the reference's ``_stack_defs``). From it:

* :func:`init_tree` materialises a flat ``{dotted path: tensor}`` dict on the
  target device. Every leaf draws from its own ``torch.Generator``, seeded
  from the seed and the leaf's path, and a stacked leaf draws layer by layer
  with the per-layer shape's law (the fan-in of the unstacked shape, as the
  reference's vmapped initializer). The numbers are not the reference's:
  ``jax.random`` cannot be reproduced, so tests carry the reference's
  parameters across (:func:`repro_torch.convert.lm_from_reference`).
* :func:`spec_tree` gives the same flat dict of **meta** tensors — shape and
  dtype, no storage — PyTorch's zero-allocation counterpart of
  ``jax.ShapeDtypeStruct``, so a configuration's bytes are known before
  anything is allocated.
* :func:`pspec_tree` maps every leaf's logical axes through a rules table
  (:func:`repro_torch.parallel.sharding.make_rules`) to a
  :class:`PartitionSpec`, the same flat dict of placements: what the dry
  run (:mod:`repro_torch.launch.dryrun`) counts each device's bytes by.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

# (generator, shape, device) -> fp32 tensor; cast to the leaf's dtype after
Initializer = Callable[[torch.Generator, tuple, torch.device], torch.Tensor]


def _normal(std: float) -> Initializer:
    def init(gen, shape, device):
        return std * torch.randn(shape, generator=gen, device=device)

    return init


def _fan_in(gen, shape, device):
    """LeCun normal over the product of all but the last dim (a 1-D
    leaf: its length)."""
    fan_in = max(1, shape[0] if shape else 1) if len(shape) <= 1 else math.prod(shape[:-1])
    return _normal(1.0 / math.sqrt(fan_in))(gen, shape, device)


INITS: dict[str, Initializer] = {
    "zeros": lambda gen, shape, device: torch.zeros(shape, device=device),
    "ones": lambda gen, shape, device: torch.ones(shape, device=device),
    "fan_in": _fan_in,
    "normal_0.02": _normal(0.02),
}


@dataclasses.dataclass(frozen=True)
class Param:
    """A parameter leaf: per-layer shape + dtype + init + logical axes, and
    ``stack``, the leading stacked-layer extents (outermost first) that
    :func:`stack_defs` adds; the full shape is ``stack + shape``."""

    shape: tuple[int, ...]
    dtype: Any = torch.float32
    init: str | Initializer = "fan_in"
    axes: tuple[Optional[str], ...] = ()
    stack: tuple[int, ...] = ()

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.stack) + len(self.shape):
            raise ValueError(f"axes {self.axes} rank mismatch with shape "
                             f"{self.stack + self.shape}")

    @property
    def full_shape(self) -> tuple[int, ...]:
        return self.stack + self.shape

    @property
    def initializer(self) -> Initializer:
        return self.init if callable(self.init) else INITS[self.init]


def stack_defs(defs, n: int, axis_name: str = "layers"):
    """Add a leading stacked-layer dim of extent ``n`` to every Param."""
    if isinstance(defs, Param):
        axes = (axis_name,) + defs.axes if defs.axes else ()
        return dataclasses.replace(defs, stack=(n,) + defs.stack, axes=axes)
    return {k: stack_defs(v, n, axis_name) for k, v in defs.items()}


def walk(defs, path=()):
    """(path, Param) pairs, keys sorted at every level."""
    if isinstance(defs, Param):
        yield path, defs
        return
    if not isinstance(defs, Mapping):
        raise TypeError(f"definition tree leaf of type {type(defs)} at {path}")
    for k in sorted(defs):
        yield from walk(defs[k], path + (str(k),))


def nest(flat: Mapping[str, Any]) -> dict:
    """``{"a.b.c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    tree: dict = {}
    for name, value in flat.items():
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _path_seed(seed: int, path: tuple[str, ...]) -> int:
    digest = hashlib.sha256(f"{seed}/{'/'.join(path)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def init_tree(defs, seed: int = 0, device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """Materialise every Param on ``device`` (``None``: the GPU); returns
    ``{dotted path: tensor}`` in sorted-path order. Deterministic in
    (seed, path) on a given device type."""
    dev = resolve_device(device)
    out = {}
    for path, p in walk(defs):
        gen = torch.Generator(device=dev).manual_seed(_path_seed(seed, path))
        t = torch.empty(p.full_shape, dtype=p.dtype, device=dev)
        layers = t.view(-1, *p.shape) if p.stack else t[None]
        for i in range(layers.shape[0]):  # one layer at a time: small fp32 scratch
            layers[i] = p.initializer(gen, p.shape, dev).to(p.dtype)
        out[".".join(path)] = t
    return out


def spec_tree(defs) -> dict[str, torch.Tensor]:
    """``{dotted path: meta tensor}`` — shapes and dtypes, no storage."""
    return {".".join(path): torch.empty(p.full_shape, dtype=p.dtype, device="meta")
            for path, p in walk(defs)}


class PartitionSpec(tuple):
    """Where each dim of an array lives on a mesh: one entry per dim, ``None``
    (replicated), a mesh-axis name, or a tuple of names (sharded over their
    product); dims past the last entry are replicated. The counterpart of
    ``jax.sharding.PartitionSpec`` with its normalisation (an empty tuple
    entry is ``None``, a one-name tuple is the name), so two specs agree
    exactly when their ``tuple(...)`` do."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def logical_to_pspec(axes, rules: Mapping[str, Any]) -> PartitionSpec:
    """Map logical axis names to mesh axes through ``rules``: a rule value is
    ``None`` (replicate), a mesh-axis name or a tuple of names. A mesh axis
    is used once a spec: a later dim that names it again drops it."""
    used: set[str] = set()
    out = []
    for name in axes:
        assignment = rules.get(name) if name is not None else None
        if assignment is None:
            out.append(None)
            continue
        entries = assignment if isinstance(assignment, tuple) else (assignment,)
        kept = tuple(a for a in entries if a not in used)
        used.update(kept)
        out.append(kept)
    return PartitionSpec(*out)


def pspec_tree(defs, rules: Mapping[str, Any]) -> dict[str, PartitionSpec]:
    """``{dotted path: PartitionSpec}`` of every leaf, the order of
    :func:`spec_tree`."""
    return {".".join(path): logical_to_pspec(p.axes, rules) for path, p in walk(defs)}


def param_bytes(defs) -> int:
    return sum(math.prod(p.full_shape) * p.dtype.itemsize for _, p in walk(defs))
