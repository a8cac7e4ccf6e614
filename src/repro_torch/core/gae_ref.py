"""Numpy oracle for the guaranteed-autoencoder post-process (Algorithm 1).

A copy of the reference's seed implementation (``core/gae_ref.py``) over
the port's own host modules: float64 throughout, per-species invocation,
and per-block Python loops for artifact assembly and decode replay. It is
the correctness contract for the device-resident engine in
:mod:`repro_torch.core.gae`, which must reproduce its byte accounting bit
for bit (same quantized coefficients, same index sets, same trimmed
basis). For the same inputs its artifacts equal the reference oracle's.

See ``gae.py``'s module docstring for the shared mathematical derivation.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import index_coding, pca
from repro_torch.core.gae import GuaranteeArtifact, _effective_bin
from repro_torch.core.quantization import dequantize, quantize


def guarantee(
    x: np.ndarray,
    x_rec: np.ndarray,
    tau: float,
    coeff_bin: float = 0.0,
) -> tuple[np.ndarray, GuaranteeArtifact]:
    """Correct ``x_rec`` so every block satisfies ||x - out||_2 <= tau.

    x, x_rec: (NB, D). Returns (corrected, artifact).
    """
    x = np.asarray(x, dtype=np.float64)
    x_rec = np.asarray(x_rec, dtype=np.float64)
    nb, d = x.shape
    residual = x - x_rec
    norms2 = np.sum(residual**2, axis=1)
    tau2 = float(tau) ** 2
    needs = norms2 > tau2

    if not needs.any():
        return x_rec.astype(np.float32), GuaranteeArtifact.empty(nb, d, float(tau))

    basis, _ = pca.pca_basis(residual)  # PCA over the *entire* residual set
    bin_size = _effective_bin(coeff_bin, float(tau), d)

    coeffs = pca.project(residual[needs], basis)  # (nf, d)
    cq_int = quantize(coeffs, bin_size)
    cq = cq_int.astype(np.float64) * bin_size
    gain = 2.0 * coeffs * cq - cq**2  # energy removed per kept coefficient

    order = np.argsort(-(coeffs**2), axis=1, kind="stable")
    sorted_gain = np.take_along_axis(gain, order, axis=1)
    cum = np.cumsum(sorted_gain, axis=1)
    target = norms2[needs][:, None] - tau2
    # smallest M with cum[M-1] >= target; quantization can make `cum`
    # non-monotone by epsilon, so use a running max before the search.
    cum_monotone = np.maximum.accumulate(cum, axis=1)
    m = 1 + np.argmax(cum_monotone >= target, axis=1)
    satisfied_at_m = np.take_along_axis(cum_monotone, (m - 1)[:, None], axis=1)[:, 0]
    # Guaranteed by bin clamp, but assert rather than assume:
    slack = 1e-9 * np.maximum(norms2[needs], 1.0)
    if not np.all(satisfied_at_m >= target[:, 0] - slack):
        raise AssertionError("guarantee violated — coefficient bin clamp failed")

    # Build per-block index sets + coefficient stream (ascending index order)
    keep_mask = np.zeros_like(coeffs, dtype=bool)
    cols = np.arange(d)[None, :]
    keep_sorted = cols < m[:, None]
    np.put_along_axis(keep_mask, order, keep_sorted, axis=1)

    corrected = x_rec.copy()
    corrected[needs] += (cq * keep_mask) @ basis.T

    fix_rows = np.nonzero(needs)[0]
    index_sets: list[np.ndarray] = [np.zeros(0, np.int64) for _ in range(nb)]
    coeff_chunks: list[np.ndarray] = []
    for local, row in enumerate(fix_rows):
        ids = np.nonzero(keep_mask[local])[0].astype(np.int64)
        index_sets[row] = ids
        coeff_chunks.append(cq_int[local, ids])
    coeff_stream = (
        np.concatenate(coeff_chunks) if coeff_chunks else np.zeros(0, np.int64)
    )
    offsets, index_flat = index_coding.sets_to_csr(index_sets)

    max_idx = max((int(ids.max()) for ids in index_sets if ids.size), default=-1)
    art = GuaranteeArtifact(
        basis=basis[:, : max_idx + 1].astype(np.float32),
        coeff_q=coeff_stream,
        index_offsets=offsets,
        index_flat=index_flat,
        coeff_bin=bin_size,
        tau=float(tau),
    )
    return corrected.astype(np.float32), art


def apply_correction(x_rec: np.ndarray, art: GuaranteeArtifact) -> np.ndarray:
    """Decode path: replay the stored correction, one block at a time."""
    out = np.asarray(x_rec, dtype=np.float64).copy()
    basis = art.basis.astype(np.float64)
    for row in range(len(art.index_offsets) - 1):
        lo, hi = art.index_offsets[row], art.index_offsets[row + 1]
        if hi == lo:
            continue
        ids = art.index_flat[lo:hi]
        c = dequantize(art.coeff_q[lo:hi], art.coeff_bin)
        out[row] += basis[:, ids] @ c.astype(np.float64)
    return out.astype(np.float32)
