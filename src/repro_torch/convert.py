"""Parameters carried between the reference's trees and PyTorch layouts.

The reference keeps parameters as nested dicts, ``{layer: {"w": ...,
"b": ...}}`` — three levels deep for the attention family
(``enc_block0/attn/wq``, ``enc_block0/ln1/scale``) — with 2-D weights as
(in, out) and convolution kernels as DHWIO. The port's modules hold the
same paths joined by dots, ``w`` / ``b`` renamed ``weight`` / ``bias``
(every other leaf keeps its name), with 2-D weights (out, in) and
convolution kernels (O, I, D, H, W). The two layouts are told apart by
rank alone, so one pair of functions serves every network of the codec:

* :func:`from_reference` — numpy tree -> flat ``state_dict`` of tensors;
* :func:`to_reference` — flat ``state_dict`` -> numpy tree.

The container's parameter streams are packed in the reference's layout and
sorted-path leaf order, so the port converts back before packing and a
blob written by either package parses under the other.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {"w": "weight", "b": "bias"}
_LEAF_BACK = {v: k for k, v in _LEAF.items()}
# leaves that keep their name: the attention family's norm scales,
# attention projections and SwiGLU weights
_NAMED = frozenset({"scale", "wq", "wk", "wv", "wo", "wg", "wu", "wd"})


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 5:  # DHWIO -> OIDHW
        return a.transpose(4, 3, 0, 1, 2)
    if a.ndim == 2:  # (in, out) -> (out, in)
        return a.T
    return a


def _to_reference_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 5:  # OIDHW -> DHWIO
        return a.transpose(2, 3, 4, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


def _leaves(tree: dict, path=()):
    """(path, leaf) pairs of a nested-dict tree, keys sorted at every level."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def from_reference(tree: dict, device=None) -> dict[str, torch.Tensor]:
    """Reference parameter tree (numpy leaves) -> flat ``state_dict``."""
    out = {}
    for path, value in _leaves(tree):
        *layers, leaf = path
        if not layers or (leaf not in _LEAF and leaf not in _NAMED):
            raise KeyError(f"unknown parameter leaf {'/'.join(path)}")
        arr = np.ascontiguousarray(
            _to_torch_layout(np.asarray(value, dtype=np.float32)))
        out[".".join([*layers, _LEAF.get(leaf, leaf)])] = torch.tensor(
            arr, device=device)
    return out


def to_reference(state: dict) -> dict:
    """Flat ``state_dict`` -> reference parameter tree (numpy fp32 leaves)."""
    tree: dict = {}
    for name, value in state.items():
        *layers, leaf = name.split(".")
        if not layers or (leaf not in _LEAF_BACK and leaf not in _NAMED):
            raise KeyError(f"unknown parameter name {name!r}")
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
            else np.asarray(value)
        node = tree
        for key in layers:
            node = node.setdefault(key, {})
        node[_LEAF_BACK.get(leaf, leaf)] = np.ascontiguousarray(
            _to_reference_layout(arr.astype(np.float32, copy=False)))
    return tree


# -- language models ---------------------------------------------------------
# The LM modules keep the reference's layouts — (in, out) weights used as
# ``x @ w``, stacked (L, ...) layer axes, (E, in, out) expert banks,
# ``lora_b`` (5, lm, d), ``conv_w`` (cw, W) — so their parameters cross with
# no transposes, by path alone. The codec's pair above decides a layout by
# rank, which cannot tell a stacked (L, in, out) weight or an expert bank
# from anything else; hence a pair of its own.


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(np.ascontiguousarray(a), device=device)


def lm_from_reference(tree: dict, device=None) -> dict[str, torch.Tensor]:
    """Reference LM parameter tree (numpy or array leaves) -> the port's flat
    ``{dotted path: tensor}`` dict, same shapes, dtypes and values; ``None``
    means the GPU (see :mod:`repro_torch.device`)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    return {".".join(path): _to_tensor(np.asarray(value), dev)
            for path, value in _leaves(tree)}


def lm_to_reference(params: dict) -> dict:
    """The port's flat LM parameters -> the reference's nested tree of numpy
    arrays (bf16 leaves as ``ml_dtypes.bfloat16``, which needs that package)."""
    tree: dict = {}
    for name, value in params.items():
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            node[leaf] = t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        else:
            node[leaf] = t.numpy().copy()
    return tree
