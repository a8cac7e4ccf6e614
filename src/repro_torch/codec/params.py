"""Parameter-tree wire packing: raw little-endian leaves, deterministic order.

The decoder / correction networks travel as *bare parameter values*: the
tree structure is fully derivable from the pipeline config, so the stream
length is exactly the byte count the paper's accounting charges for the
networks — no per-leaf framing.

Trees here are the reference package's: nested dicts
``{layer: {"w": ..., "b": ...}}`` of numpy leaves in the reference's
layouts (dense (in, out), conv kernels DHWIO), which is what the wire
carries; ``defs`` is the matching tree of shapes. See
:mod:`repro_torch.convert` for the PyTorch layouts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.container import ContainerFormatError
from repro_torch.core.quantization import param_storage_dtype


def _walk(defs, path=()):
    """(path, shape) pairs of a shape tree, keys sorted at every level."""
    if isinstance(defs, dict):
        for k in sorted(defs):
            yield from _walk(defs[k], path + (str(k),))
    else:
        yield path, tuple(int(n) for n in defs)


def _sorted_leaves(tree):
    """Depth-first leaves of a nested-dict tree, keys sorted at every level
    (the same order as :func:`_walk` over the shape tree)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    else:
        yield tree


def pack_params(tree, param_dtype_bytes: int) -> bytes:
    """Concatenate pytree leaves as raw storage-dtype bytes, no framing."""
    dtype = param_storage_dtype(param_dtype_bytes)
    return b"".join(
        np.ascontiguousarray(np.asarray(leaf)).astype(dtype).tobytes()
        for leaf in _sorted_leaves(tree)
    )


def unpack_params(buf: bytes, defs, param_dtype_bytes: int):
    """Inverse of :func:`pack_params` given the matching shape tree."""
    dtype = param_storage_dtype(param_dtype_bytes)
    walk = list(_walk(defs))
    expected = sum(
        int(np.prod(shape)) * dtype.itemsize for _, shape in walk
    )
    if len(buf) != expected:
        raise ContainerFormatError(
            f"parameter stream is {len(buf)} bytes, expected {expected}"
        )
    out: dict = {}
    off = 0
    for path, shape in walk:
        n = int(np.prod(shape))
        leaf = (
            np.frombuffer(buf, dtype=dtype, count=n, offset=off)
            .astype(np.float32)
            .reshape(shape)
        )
        off += n * dtype.itemsize
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def pack_artifact_params(
    ae_params, corr_params, param_dtype_bytes: int
) -> tuple[bytes, Optional[bytes]]:
    """Packed (decoder, correction) wire streams — the single source for
    the decoder-key filter and tuple layout (correction is None when the
    artifact carries no correction network)."""
    dec = {k: v for k, v in ae_params.items() if k.startswith("dec")}
    return (
        pack_params(dec, param_dtype_bytes),
        pack_params(corr_params, param_dtype_bytes)
        if corr_params is not None
        else None,
    )
