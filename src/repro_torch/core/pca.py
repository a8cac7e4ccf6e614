"""Residual PCA (paper §II-A).

The guarantee post-process runs PCA on the residual matrix R (NB x D, blocks
as instances). D is small (paper: 80) while NB is large, so we form the D x D
Gram matrix in float64 and eigendecompose — O(NB*D^2) flops, numerically
comfortable, and exactly orthonormal basis vectors (required for the
cumulative-energy argument that makes Algorithm 1 vectorizable).
"""

from __future__ import annotations

import numpy as np


def pca_basis(residual: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (U, eigvals) with columns of U sorted by descending eigenvalue.

    residual: (NB, D). The paper does not center the residual before PCA
    (Algorithm 1 projects raw residuals), so neither do we — U must span the
    residuals themselves for ``x^R + U c`` to reconstruct exactly.
    """
    r = residual.astype(np.float64)
    gram = r.T @ r
    eigvals, eigvecs = np.linalg.eigh(gram)
    order = np.argsort(eigvals)[::-1]
    return eigvecs[:, order], np.maximum(eigvals[order], 0.0)


def pca_basis_stack(
    residuals: np.ndarray, executor=None
) -> tuple[np.ndarray, np.ndarray]:
    """Per-species bases for a (S, NB, D) residual stack.

    The grams are computed as one batched matmul — BLAS runs the same GEMM
    per slice, so the result is bit-identical to :func:`pca_basis`'s
    ``r.T @ r`` (asserted by the engine/oracle parity suite); each slice
    then goes through exactly the same eigh/ordering as a standalone call.
    The guarantee engine's byte-accounting parity with the numpy oracle
    depends on these bases matching bit for bit. ``executor`` optionally
    parallelizes the per-slice eigh (LAPACK releases the GIL; slices are
    independent, so results do not depend on scheduling).
    """
    s, _, d = residuals.shape
    r = residuals.astype(np.float64)
    grams = np.matmul(r.transpose(0, 2, 1), r)
    bases = np.empty((s, d, d), np.float64)
    eigvals = np.empty((s, d), np.float64)

    def work(sidx):
        ev, evec = np.linalg.eigh(grams[sidx])
        order = np.argsort(ev)[::-1]
        bases[sidx] = evec[:, order]
        eigvals[sidx] = np.maximum(ev[order], 0.0)

    if executor is None:
        for sidx in range(s):
            work(sidx)
    else:
        list(executor.map(work, range(s)))
    return bases, eigvals


def project(residual: np.ndarray, basis: np.ndarray) -> np.ndarray:
    """c = U^T r for each block row: (NB, D) @ (D, D) -> (NB, D)."""
    return residual.astype(np.float64) @ basis
