"""Parameters carried between the reference's trees and PyTorch layouts.

The reference keeps parameters as nested dicts, ``{layer: {"w": ..., "b":
...}}``, with dense ``w`` as (in, out) and convolution kernels as DHWIO.
The port's modules hold ``{layer}.weight`` / ``{layer}.bias`` with dense
weights (out, in) and convolution kernels (O, I, D, H, W). The two layouts
are told apart by rank alone, so one pair of functions serves the
autoencoder and the correction network:

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


def from_reference(tree: dict, device=None) -> dict[str, torch.Tensor]:
    """Reference parameter tree (numpy leaves) -> flat ``state_dict``."""
    out = {}
    for layer in sorted(tree):
        for leaf, value in tree[layer].items():
            if leaf not in _LEAF:
                raise KeyError(f"unknown parameter leaf {layer}/{leaf}")
            arr = np.ascontiguousarray(
                _to_torch_layout(np.asarray(value, dtype=np.float32)))
            out[f"{layer}.{_LEAF[leaf]}"] = torch.tensor(arr, device=device)
    return out


def to_reference(state: dict) -> dict:
    """Flat ``state_dict`` -> reference parameter tree (numpy fp32 leaves)."""
    tree: dict = {}
    for name, value in state.items():
        layer, _, leaf = name.rpartition(".")
        if leaf not in _LEAF_BACK or not layer:
            raise KeyError(f"unknown parameter name {name!r}")
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
            else np.asarray(value)
        tree.setdefault(layer, {})[_LEAF_BACK[leaf]] = np.ascontiguousarray(
            _to_reference_layout(arr.astype(np.float32, copy=False)))
    return tree
