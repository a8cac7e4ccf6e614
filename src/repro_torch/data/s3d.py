"""Synthetic S3D HCCI surrogate (paper §III dataset stand-in).

The real dataset — 640x640 grid, 50 time steps (t = 1.5..2.0 ms), 58-species
reduced n-heptane mechanism — is not distributable, so the reproduction runs
on a calibrated surrogate that preserves exactly the structure GBATC exploits
and SZ competes on:

* smooth spatial fields with turbulent-like spectra (k^-beta Gaussian random
  fields) advected over time -> strong spatiotemporal correlation;
* an ignition progress variable with spatially varying delay -> moving sharp
  fronts and exponential species growth/decay (the paper's "values may
  increase or decrease exponentially");
* species constructed as nonlinear responses of a handful of latent fields
  (mixture fraction, progress, strain, temperature) with random per-species
  parameters -> low intrinsic dimensionality but high *linear* rank (the
  paper reports rank 46/58 for NRMSE 1e-3), majors O(1e-1) and minors down to
  O(1e-8) with mid-ignition bumps.

`generate` returns the (S, T, H, W) mass-fraction array plus the temperature
field used by the QoI surrogate.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class S3DConfig:
    n_species: int = 58
    n_time: int = 50
    height: int = 640
    width: int = 640
    seed: int = 0
    # spectral slope of the random fields (3D turbulence-like)
    beta: float = 3.0
    # fraction of species treated as majors (smooth, O(1) mass fraction)
    major_frac: float = 0.15

    def scaled(self, *, n_species=16, n_time=24, height=80, width=80) -> "S3DConfig":
        return dataclasses.replace(
            self, n_species=n_species, n_time=n_time, height=height, width=width
        )


PAPER_CONFIG = S3DConfig()
# Test/CI-scale config: divisible by the paper block geometry (4, 5, 4).
SMALL_CONFIG = S3DConfig(n_species=16, n_time=24, height=80, width=80, seed=0)


def _grf(rng: np.random.Generator, h: int, w: int, beta: float) -> np.ndarray:
    """Gaussian random field with k^-beta spectrum, unit std."""
    kx = np.fft.fftfreq(h)[:, None]
    ky = np.fft.fftfreq(w)[None, :]
    k = np.sqrt(kx**2 + ky**2)
    k[0, 0] = 1.0
    amp = k ** (-beta / 2.0)
    amp[0, 0] = 0.0
    noise = rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w))
    field = np.fft.ifft2(noise * amp).real
    field -= field.mean()
    std = field.std()
    return field / (std if std > 0 else 1.0)


def _advect(field: np.ndarray, shift_y: float, shift_x: float) -> np.ndarray:
    """Periodic sub-pixel advection via Fourier phase shift."""
    h, w = field.shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    phase = np.exp(-2j * np.pi * (fy * shift_y + fx * shift_x))
    return np.fft.ifft2(np.fft.fft2(field) * phase).real


def _base_fields(cfg: S3DConfig) -> dict[str, np.ndarray]:
    """Time-independent latent fields + drift — all of ``generate``'s rng
    consumption, in the exact draw order, so any frame subset derived from
    these is bit-identical to the corresponding slice of a full run."""
    rng = np.random.default_rng(cfg.seed)
    h, w = cfg.height, cfg.width
    mixture = _grf(rng, h, w, cfg.beta)  # mixture fraction Z
    strain = _grf(rng, h, w, cfg.beta)  # local strain proxy
    modulation = _grf(rng, h, w, cfg.beta - 0.5)  # extra rank-raising mode
    # spatially varying ignition delay in [0.25, 0.75] of the window,
    # correlated with mixture and strain (rich/strained pockets ignite late)
    delay = 0.5 + 0.12 * mixture + 0.08 * strain
    width_ign = 0.06 * (1.0 + 0.3 * np.tanh(modulation))
    drift = rng.normal(scale=0.8, size=(2,))
    return {
        "mixture": mixture, "strain": strain, "modulation": modulation,
        "delay": delay, "width_ign": width_ign, "drift": drift,
    }


def _frame_fields(cfg: S3DConfig, base: dict, t0: int, t1: int):
    """(progress, mix, strain, mod) advected fields for frames [t0, t1).

    Every frame is an independent function of the base fields and its own
    time value, so a window is bitwise the slice of the full series.
    """
    h, w = cfg.height, cfg.width
    drift = base["drift"]
    times = np.linspace(0.0, 1.0, cfg.n_time)[t0:t1]
    t = len(times)
    progress = np.empty((t, h, w), dtype=np.float64)
    mix_t = np.empty((t, h, w), dtype=np.float64)
    strain_t = np.empty((t, h, w), dtype=np.float64)
    mod_t = np.empty((t, h, w), dtype=np.float64)
    for i, tt in enumerate(times):
        mix_t[i] = _advect(base["mixture"], drift[0] * tt * h * 0.02,
                           drift[1] * tt * w * 0.02)
        strain_t[i] = _advect(base["strain"], -drift[1] * tt * h * 0.015,
                              drift[0] * tt * w * 0.015)
        mod_t[i] = _advect(base["modulation"], drift[0] * tt * h * 0.01,
                           -drift[0] * tt * w * 0.02)
        progress[i] = 1.0 / (1.0 + np.exp(-(tt - base["delay"])
                                          / base["width_ign"]))
    return progress, mix_t, strain_t, mod_t


def _species_responses(cfg: S3DConfig, progress, mix_t, strain_t, mod_t
                       ) -> np.ndarray:
    """Per-species nonlinear responses over the given frames (elementwise
    in time, so chunked evaluation is bitwise equal to full)."""
    s = cfg.n_species
    n_major = max(2, int(round(cfg.major_frac * s)))
    species = np.empty((s, *progress.shape), dtype=np.float32)
    c = progress
    z = mix_t
    st = strain_t
    md = mod_t
    for j in range(s):
        rj = np.random.default_rng(cfg.seed * 1000 + 17 + j)
        if j == 0:  # fuel: consumed through ignition
            y = 0.06 * (1.0 - c) * (1.0 + 0.25 * z)
        elif j == 1:  # oxidizer
            y = 0.22 * (1.0 - 0.85 * c) * (1.0 - 0.1 * z)
        elif j < n_major:  # products (CO2/H2O/CO-like): grow with progress
            a = rj.uniform(0.02, 0.12)
            y = a * c * (1.0 + 0.2 * np.tanh(z + 0.3 * md))
        else:  # minors: exponential bumps around a per-species progress point
            logamp = rj.uniform(-8.0, -2.5)  # spans O(1e-8)..O(1e-3) peaks
            c0 = rj.uniform(0.15, 0.9)
            sig = rj.uniform(0.05, 0.25)
            sens = rj.uniform(1.0, 4.0)
            y = (10.0**logamp) * np.exp(
                -(((c - c0) / sig) ** 2) + sens * 0.3 * z + 0.2 * st
            )
        species[j] = y.astype(np.float32)
    return species


def generate(cfg: S3DConfig) -> dict[str, np.ndarray]:
    base = _base_fields(cfg)
    progress, mix_t, strain_t, mod_t = _frame_fields(cfg, base, 0, cfg.n_time)
    temperature = 900.0 + 1400.0 * progress + 40.0 * mix_t  # K
    species = _species_responses(cfg, progress, mix_t, strain_t, mod_t)
    return {
        "species": species,  # (S, T, H, W) float32 mass fractions
        "temperature": temperature.astype(np.float32),  # (T, H, W)
        "progress": progress.astype(np.float32),
    }


def generate_species_window(cfg: S3DConfig, t0: int, t1: int,
                            base: dict | None = None) -> np.ndarray:
    """Species mass fractions for frames ``[t0, t1)`` only.

    Bitwise equal to ``generate(cfg)["species"][:, t0:t1]`` while
    materializing just the window's frames (plus the (H, W) base fields) —
    the streaming producer behind :class:`S3DChunkLoader`. ``base``
    reuses precomputed :func:`_base_fields` across windows.
    """
    if not 0 <= t0 < t1 <= cfg.n_time:
        raise ValueError(
            f"frame window ({t0}, {t1}) outside [0, {cfg.n_time})"
        )
    if base is None:
        base = _base_fields(cfg)
    return _species_responses(cfg, *_frame_fields(cfg, base, t0, t1))


class S3DChunkLoader:
    """Re-iterable time-chunked view of the surrogate's species field.

    Feeds ``GBATCCodec.fit_stream`` / ``GBATCPipeline.fit_stream``: each
    ``chunks()`` pass yields consecutive ``(S, chunk_frames, H, W)``
    arrays (ragged tail allowed) that concatenate — bitwise — to
    ``generate(cfg)["species"]``, without the full field ever existing in
    memory. The time-independent base fields are computed once per loader;
    per-chunk cost is the window's frames only.
    """

    def __init__(self, cfg: S3DConfig, chunk_frames: int):
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        self.cfg = cfg
        self.chunk_frames = int(chunk_frames)
        self._base = _base_fields(cfg)

    @property
    def shape(self) -> tuple[int, int, int, int]:
        cfg = self.cfg
        return (cfg.n_species, cfg.n_time, cfg.height, cfg.width)

    @property
    def n_chunks(self) -> int:
        return -(-self.cfg.n_time // self.chunk_frames)

    def chunks(self):
        for t0 in range(0, self.cfg.n_time, self.chunk_frames):
            t1 = min(t0 + self.chunk_frames, self.cfg.n_time)
            yield generate_species_window(self.cfg, t0, t1, base=self._base)
