"""Uniform mid-tread quantization (paper §II-A).

Values are binned with bin size ``d`` and represented by the bin center:
``q = round(x / d)``; ``x_hat = q * d``; worst-case error d/2 per scalar.
The integer streams feed the entropy coder.
"""

from __future__ import annotations

import numpy as np


def quantize(x: np.ndarray, bin_size: float) -> np.ndarray:
    if bin_size <= 0:
        raise ValueError("bin_size must be positive")
    return np.rint(x / bin_size).astype(np.int64)


def dequantize(q: np.ndarray, bin_size: float) -> np.ndarray:
    # float64 so the bin/2 bound is exact; callers cast on storage.
    return q.astype(np.float64) * bin_size


def quantize_roundtrip(x: np.ndarray, bin_size: float) -> tuple[np.ndarray, np.ndarray]:
    q = quantize(x, bin_size)
    return q, dequantize(q, bin_size)


def param_storage_dtype(param_dtype_bytes: int) -> np.dtype:
    """Numpy dtype for stored network parameters (fp16 or fp32)."""
    try:
        return {2: np.dtype("<f2"), 4: np.dtype("<f4")}[int(param_dtype_bytes)]
    except KeyError:
        raise ValueError(
            f"param_dtype_bytes must be 2 or 4, got {param_dtype_bytes}"
        ) from None


def quantize_params(tree, param_dtype_bytes: int):
    """Round every leaf of a (nested-dict, numpy-leaf) parameter tree through its storage dtype.

    Run at fit time when parameters are stored below fp32 so the encoder
    computes latents/corrections/guarantees with *exactly* the values the
    container will carry — otherwise the serialized decoder drifts from the
    one the guarantee was computed against and the error bound is fiction.
    fp32 storage is the identity. Compute dtype stays float32.
    """
    dtype = param_storage_dtype(param_dtype_bytes)
    if dtype.itemsize == 4:
        return tree

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return np.asarray(node).astype(dtype).astype(np.float32)

    return rec(tree)


def per_channel_scale(x: np.ndarray, axis: int, n_bits: int = 8) -> np.ndarray:
    """Symmetric per-channel scale for int quantization (KV/grad compression)."""
    amax = np.max(np.abs(x), axis=axis, keepdims=True)
    qmax = float(2 ** (n_bits - 1) - 1)
    return np.maximum(amax, 1e-30) / qmax
