"""Quantity-of-interest surrogate: Arrhenius net production rates.

The paper's QoI is the per-species net production rate computed by Cantera
from the reconstructed mass fractions: an O(N) nonlinear map through
forward/reverse Arrhenius rate constants. Cantera is unavailable offline,
so the same mathematical structure is implemented directly:

  k_f,r = A_r * T^b_r * exp(-Ea_r / (R T))
  k_r,r = k_f,r / Keq_r,  Keq_r = exp(dS_r/R - dH_r/(R T))
  rate_r = k_f,r * prod_i [X_i]^nu'_ir  -  k_r,r * prod_j [X_j]^nu''_jr
  wdot_s = sum_r (nu''_sr - nu'_sr) * rate_r,   [X_i] = rho Y_i / W_i

with a randomly generated (but fixed-seed) elementary mechanism over the S
species. This preserves the error-amplification behaviour the paper
studies: minor-species errors blow up through the exponentials and
high-order concentration products.

:class:`Mechanism` and :func:`make_mechanism` are copies of the
reference's (``core/qoi.py``, host numpy). :func:`production_rates` is
the reference's jitted map as torch ops on the device, in **fp32**: the
reference's host entry casts its inputs to float64, but JAX without
``jax_enable_x64`` computes them in fp32, so fp32 is the function it
runs. Matrix products run with TF32 off. The map is a plain product and
exponential with no Pallas kernel in the reference, so plain torch is its
port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, strict_fp32

R_GAS = 8.314462618  # J/(mol K)

_CHUNK = 1 << 18  # grid points per launch group: bounds the (points, NR)
# intermediates at 1 GB each for the paper's 232 reactions


@dataclasses.dataclass(frozen=True)
class Mechanism:
    nu_fwd: np.ndarray  # (S, NR) reactant stoichiometry
    nu_rev: np.ndarray  # (S, NR) product stoichiometry
    log_a: np.ndarray  # (NR,)
    beta: np.ndarray  # (NR,)
    ea: np.ndarray  # (NR,) J/mol
    ds: np.ndarray  # (NR,) J/(mol K)
    dh: np.ndarray  # (NR,) J/mol
    mol_weight: np.ndarray  # (S,) kg/mol
    density: float = 1.0  # kg/m^3 (constant-volume surrogate)


def make_mechanism(n_species: int, n_reactions: int | None = None, seed: int = 7) -> Mechanism:
    rng = np.random.default_rng(seed)
    nr = n_reactions or 4 * n_species
    nu_f = np.zeros((n_species, nr))
    nu_r = np.zeros((n_species, nr))
    for r in range(nr):
        reactants = rng.choice(n_species, size=rng.integers(1, 3), replace=False)
        products = rng.choice(
            [s for s in range(n_species) if s not in reactants],
            size=rng.integers(1, 3),
            replace=False,
        )
        nu_f[reactants, r] = rng.integers(1, 3, size=len(reactants))
        nu_r[products, r] = rng.integers(1, 3, size=len(products))
    return Mechanism(
        nu_fwd=nu_f,
        nu_rev=nu_r,
        log_a=rng.uniform(2.0, 10.0, nr),  # log10 pre-exponential
        beta=rng.uniform(-0.5, 1.5, nr),
        ea=rng.uniform(2.0e4, 1.6e5, nr),
        ds=rng.uniform(-40.0, 40.0, nr),
        dh=rng.uniform(-2.0e5, 2.0e5, nr),
        mol_weight=rng.uniform(0.002, 0.12, n_species),
    )


def _f32(x, device: torch.device) -> torch.Tensor:
    """fp32 on ``device``: host arrays round once to fp32 (as the
    reference's ``jnp.asarray`` does), tensors must already be there."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"tensor on {x.device}, but device={device} was requested")
        return x.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


def _mechanism_tensors(mech: Mechanism, device: torch.device) -> dict:
    ln10 = torch.log(torch.tensor(10.0, dtype=torch.float32))  # fp32, as jnp.log(10.0)
    t = {name: _f32(getattr(mech, name), device)
         for name in ("nu_fwd", "nu_rev", "log_a", "beta", "ea", "ds", "dh")}
    t["log_a"] = t["log_a"] * ln10.to(device)
    t["inv_w"] = _f32(1.0 / mech.mol_weight, device)  # fp64 reciprocal, one round
    t["nu_net_t"] = (t["nu_rev"] - t["nu_fwd"]).T.contiguous()
    return t


def _rates(m: dict, rho: float, y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The reference's ``_rates_jit`` body, term for term, in fp32."""
    conc = rho * y * m["inv_w"]
    log_conc = torch.log(torch.clamp(conc, min=1e-30))  # fp32-safe floor
    tt = t[..., None]
    rt = R_GAS * tt
    log_kf = m["log_a"] + m["beta"] * torch.log(tt) - m["ea"] / rt
    log_kr = log_kf - (m["ds"] / R_GAS - m["dh"] / rt)
    # clamp exponents: physically k*prod[X] stays finite; random mechanisms
    # can otherwise overflow
    fwd = torch.exp(torch.clamp(log_kf + log_conc @ m["nu_fwd"], -700.0, 700.0))
    rev = torch.exp(torch.clamp(log_kr + log_conc @ m["nu_rev"], -700.0, 700.0))
    return (fwd - rev) @ m["nu_net_t"]


def production_rates(mech: Mechanism, y, temperature,
                     device: DeviceLike = None) -> torch.Tensor:
    """wdot for each species, fp32 on ``device``. y: (..., S) mass
    fractions; temperature: (...). Host arrays are staged to ``device``;
    tensors must already be on it. ``device=None`` means the GPU and
    raises without CUDA."""
    dev = resolve_device(device)
    y32, t32 = _f32(y, dev), _f32(temperature, dev)
    s = y32.shape[-1]
    lead = t32.shape
    if tuple(y32.shape[:-1]) != tuple(lead):
        raise ValueError(f"y {tuple(y32.shape)} and temperature {tuple(lead)} "
                         "do not share their leading shape")
    m = _mechanism_tensors(mech, dev)
    yy, tt = y32.reshape(-1, s), t32.reshape(-1)
    with torch.no_grad(), strict_fp32():
        out = torch.cat([_rates(m, float(mech.density), yy[i : i + _CHUNK],
                                tt[i : i + _CHUNK])
                         for i in range(0, max(tt.shape[0], 1), _CHUNK)])
    return out.reshape(*lead, s)


def production_rates_np(mech: Mechanism, y: np.ndarray, temperature: np.ndarray,
                        device: DeviceLike = None) -> np.ndarray:
    """Batched host entry point: y (S, T, H, W), temperature (T, H, W) ->
    (S, T, H, W) fp32 on the host, computed on ``device`` (``None``: the
    GPU)."""
    s = y.shape[0]
    yy = np.moveaxis(np.asarray(y), 0, -1).reshape(-1, s)
    tt = np.asarray(temperature).reshape(-1)
    out = production_rates(mech, yy, tt, device=device).cpu().numpy()
    return np.moveaxis(out.reshape(tuple(temperature.shape) + (s,)), -1, 0)

