"""Reconstruction quality metrics: NRMSE (paper eq. 3), PSNR, SSIM."""

from __future__ import annotations

import numpy as np


def nrmse(x: np.ndarray, x_rec: np.ndarray) -> float:
    """Range-normalized RMSE for a single species (paper eq. 3)."""
    x = np.asarray(x, dtype=np.float64)
    x_rec = np.asarray(x_rec, dtype=np.float64)
    rng = float(x.max() - x.min())
    if rng == 0.0:
        return 0.0 if np.allclose(x, x_rec) else float("inf")
    rmse = float(np.sqrt(np.mean((x - x_rec) ** 2)))
    return rmse / rng


def mean_nrmse(x: np.ndarray, x_rec: np.ndarray, species_axis: int = 0) -> float:
    """Paper's headline metric: average per-species NRMSE."""
    x = np.moveaxis(x, species_axis, 0)
    x_rec = np.moveaxis(x_rec, species_axis, 0)
    return float(np.mean([nrmse(a, b) for a, b in zip(x, x_rec)]))


def psnr(x: np.ndarray, x_rec: np.ndarray) -> float:
    """Range-referenced PSNR; the zero-range and zero-error cases are
    handled explicitly (like :func:`nrmse`) instead of leaking a
    ``log10(0)`` RuntimeWarning and a surprise ``-inf``/``nan``."""
    x = np.asarray(x, dtype=np.float64)
    x_rec = np.asarray(x_rec, dtype=np.float64)
    rng = float(x.max() - x.min())
    mse = float(np.mean((x - x_rec) ** 2))
    if mse == 0.0:
        return float("inf")
    if rng == 0.0:
        # constant-range reference with nonzero error: no finite dB value
        # is meaningful, and log10(rng) would warn-and-return -inf
        return float("-inf")
    return 20.0 * np.log10(rng) - 10.0 * np.log10(mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    k = np.outer(g, g)
    return k / k.sum()


def _filter2d_valid(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Valid-mode 2D correlation via stride tricks (no scipy available)."""
    kh, kw = kernel.shape
    h, w = img.shape
    windows = np.lib.stride_tricks.sliding_window_view(img, (kh, kw))
    return np.einsum("ijkl,kl->ij", windows, kernel, optimize=True)


def ssim2d(x: np.ndarray, y: np.ndarray) -> float:
    """SSIM between two 2D fields, 11x11 gaussian window, standard constants."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    rng = float(max(x.max() - x.min(), 1e-30))
    c1, c2 = (0.01 * rng) ** 2, (0.03 * rng) ** 2
    k = _gaussian_kernel()
    mu_x = _filter2d_valid(x, k)
    mu_y = _filter2d_valid(y, k)
    xx = _filter2d_valid(x * x, k) - mu_x**2
    yy = _filter2d_valid(y * y, k) - mu_y**2
    xy = _filter2d_valid(x * y, k) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (xx + yy + c2)
    return float(np.mean(num / den))
