"""The port's host baselines and oracles against the reference's.

* ``repro_torch.core.sz`` (the SZ3-style baseline, host numpy over the
  port's entropy coder): for the shapes and bounds of the reference's
  ``tests/test_sz.py`` and one 58-species ``compress_species`` case,
  ``SZArtifact.to_bytes()`` is **byte-identical** to the reference's and
  ``decompress`` is bitwise equal; each side reads the other's bytes.
* ``repro_torch.core.gae_ref`` (the numpy oracle of Algorithm 1):
  ``guarantee`` gives the reference oracle's corrected blocks and
  artifacts bit for bit, and ``apply_correction`` replays bitwise.
* ``repro_torch.core.qoi``: the mechanism equals the reference's, and
  ``production_rates_np`` (fp32 torch, here on the CPU) agrees with the
  reference's ``production_rates_np``, which runs in fp32 because JAX
  computes without x64, to ``QOI_RTOL`` of each species' largest
  |rate|. The two are not bitwise: XLA and torch sum the reaction
  products of large rates of both signs in different orders (measured
  worst 5.7e-6 of a species' largest rate, the size of the fp32/fp64
  gap of the reference itself).
"""

import numpy as np
import pytest
import torch

from repro.core import gae_ref as r_gae_ref
from repro.core import qoi as r_qoi
from repro.core import sz as r_sz
from repro.data import s3d
from repro_torch.core import gae as t_gae
from repro_torch.core import gae_ref as t_gae_ref
from repro_torch.core import qoi as t_qoi
from repro_torch.core import sz as t_sz

QOI_RTOL = 5e-5  # of each species' largest |rate|; measured worst 5.7e-6


def _smooth_field(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    for ax in range(3):  # crude smoothing -> compressible field
        for _ in range(3):
            x = 0.5 * x + 0.25 * (np.roll(x, 1, ax) + np.roll(x, -1, ax))
    return x.astype(np.float32)


def _spiked(seed, shape, at, value):
    data = _smooth_field(seed, shape)
    data[at] = value
    return data


def _random_case(trial):
    rng = np.random.default_rng(200 + trial)
    shape = tuple(int(rng.integers(4, 40)) for _ in range(3))
    eb = 10.0 ** rng.uniform(-6, -1)
    return _smooth_field(trial, shape) * 10.0 ** rng.uniform(-3, 3), eb


def _sz_cases():
    """(id, data, abs_eb): every field and bound of tests/test_sz.py."""
    cases = [(f"bound{eb:g}", _smooth_field(0, (16, 24, 20)), eb)
             for eb in (1e-1, 1e-3, 1e-5)]
    cases += [(f"shape{'x'.join(map(str, sh))}", _smooth_field(1, sh), 1e-3)
              for sh in ((8, 8, 8), (10, 33, 47), (4, 5, 6), (50, 12, 9))]
    smooth = _smooth_field(2, (16, 48, 48))
    cases.append(("smooth", smooth, 1e-2 * float(smooth.max() - smooth.min())))
    cases += [(f"tighter{eb:g}", _smooth_field(3, (16, 32, 32)), eb)
              for eb in (1e-2, 1e-4)]
    cases.append(("constant", np.full((8, 16, 16), 3.25, np.float32), 1e-6))
    cases.append(("outlier", _spiked(4, (8, 16, 16), (3, 7, 9), 1e9), 1e-7))
    cases += [(f"random{trial}", *_random_case(trial)) for trial in range(5)]
    cases.append(("large_offset",
                  (_smooth_field(7, (8, 24, 24)) + 4096.0).astype(np.float32), 2e-4))
    cases.append(("negative_spike", _spiked(4, (8, 16, 16), (2, 3, 5), -1e8), 1e-6))
    cases.append(("truncation_field", _smooth_field(5, (8, 12, 10)), 1e-3))
    return cases


SZ_CASES = _sz_cases()


@pytest.mark.parametrize("data, eb", [c[1:] for c in SZ_CASES],
                         ids=[c[0] for c in SZ_CASES])
def test_sz_bytes_identical_and_decode_bitwise(data, eb):
    a, b = t_sz.compress(data, eb), r_sz.compress(data, eb)
    wire = a.to_bytes()
    assert wire == b.to_bytes()
    assert a.payload_bytes() == b.payload_bytes() == len(wire)
    assert a.recon.tobytes() == b.recon.tobytes()
    assert a.outlier_values.tobytes() == b.outlier_values.tobytes()
    dec = t_sz.decompress(a)
    assert dec.dtype == np.float64
    assert dec.tobytes() == r_sz.decompress(b).tobytes()
    # each package reads the other's bytes
    for back in (t_sz.SZArtifact.from_bytes(b.to_bytes()),
                 r_sz.SZArtifact.from_bytes(wire)):
        assert back.recon is None
        np.testing.assert_array_equal(back.quant_stream, a.quant_stream)
    assert t_sz.decompress(t_sz.SZArtifact.from_bytes(b.to_bytes())).tobytes() \
        == dec.tobytes()
    # the pointwise bound the baseline guarantees
    assert np.abs(a.recon - data.astype(np.float64)).max() <= eb * (1 + 1e-9)


def test_sz_truncated_wire_raises_like_the_reference():
    wire = t_sz.compress(_smooth_field(5, (8, 12, 10)), 1e-3).to_bytes()
    for cut in (16, len(wire) - 4):
        with pytest.raises(ValueError):
            t_sz.SZArtifact.from_bytes(wire[:cut])
        with pytest.raises(ValueError):
            r_sz.SZArtifact.from_bytes(wire[:cut])


def test_sz_compress_species_58():
    """One 58-species field at per-species bounds, as the paper's
    baseline is run: the same reconstruction and the same byte count."""
    data = s3d.generate(s3d.S3DConfig(
        n_species=58, n_time=4, height=20, width=16, seed=5))["species"]
    ranges = data.max(axis=(1, 2, 3)) - data.min(axis=(1, 2, 3))
    eb = 1e-3 * ranges.astype(np.float64)
    recon_t, total_t = t_sz.compress_species(data, eb)
    recon_r, total_r = r_sz.compress_species(data, eb)
    assert recon_t.dtype == np.float64
    assert recon_t.tobytes() == recon_r.tobytes()
    assert total_t == total_r
    for s in (0, 29, 57):
        assert t_sz.compress(data[s], float(eb[s])).to_bytes() \
            == r_sz.compress(data[s], float(eb[s])).to_bytes()
    err = np.abs(recon_t - data.astype(np.float64)).max(axis=(1, 2, 3))
    assert (err <= eb * (1 + 1e-9)).all()


# -- gae_ref: the numpy oracle of Algorithm 1 --------------------------------
def _blocks(seed, nb=200, d=80, noise=0.05, clean_rows=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nb, d)).astype(np.float32)
    x_rec = (x + noise * rng.normal(size=(nb, d))).astype(np.float32)
    if clean_rows:
        x_rec[:clean_rows] = x[:clean_rows]
    return x, x_rec


def _same_artifact(a, b):
    for field in ("basis", "coeff_q", "index_offsets", "index_flat"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        assert x.tobytes() == y.tobytes(), field
    assert a.coeff_bin == b.coeff_bin and a.tau == b.tau


@pytest.mark.parametrize("seed, noise, tau, coeff_bin, clean_rows", [
    (0, 0.05, 0.1, 0.0, 0),
    (1, 0.05, 0.3, 0.0, 50),
    (2, 0.2, 0.5, 0.01, 0),
    (3, 0.01, 0.02, 0.0, 0),
    (4, 0.05, 10.0, 0.0, 0),       # nothing needs correcting
    (5, 0.1, 0.2, 1.0, 20),        # a bin above the clamp
])
def test_gae_ref_artifacts_bitwise_the_reference(seed, noise, tau, coeff_bin,
                                                 clean_rows):
    x, x_rec = _blocks(seed, noise=noise, clean_rows=clean_rows)
    got_c, got = t_gae_ref.guarantee(x, x_rec, tau, coeff_bin)
    want_c, want = r_gae_ref.guarantee(x, x_rec, tau, coeff_bin)
    assert got_c.dtype == want_c.dtype == np.float32
    assert got_c.tobytes() == want_c.tobytes()
    _same_artifact(got, want)
    assert isinstance(got, t_gae.GuaranteeArtifact)
    replay = t_gae_ref.apply_correction(x_rec, got)
    assert replay.tobytes() == r_gae_ref.apply_correction(x_rec, want).tobytes()
    # every block meets tau (the oracle's own contract)
    err = np.linalg.norm(x.astype(np.float64) - got_c.astype(np.float64), axis=1)
    assert (err <= tau * (1 + 1e-5)).all()


def test_gae_ref_is_the_port_engines_oracle():
    """The port's engine (host select, CPU) against the port's oracle:
    the same artifacts bit for bit, as against the reference's."""
    x, x_rec = _blocks(11, nb=160)
    tau = 0.1
    engine = t_gae.GuaranteeEngine("cpu", select_backend="host")
    corrected, arts = engine.select(engine.prepare(x[None], x_rec[None]), tau)
    want_c, want = t_gae_ref.guarantee(x, x_rec, tau)
    _same_artifact(arts[0], want)
    np.testing.assert_allclose(corrected[0], want_c, rtol=0, atol=1e-6)


# -- QoI ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def qoi_fields():
    out = {}
    for s, shape, seed in ((8, (4, 20, 16), 3), (58, (4, 20, 20), 0)):
        ds = s3d.generate(s3d.S3DConfig(n_species=s, n_time=shape[0],
                                        height=shape[1], width=shape[2], seed=seed))
        out[s] = ds["species"], ds["temperature"]
    return out


@pytest.mark.parametrize("n_species, n_reactions, seed", [
    (8, None, 7), (58, None, 7), (6, 10, 3)])
def test_mechanism_equals_the_reference(n_species, n_reactions, seed):
    a = t_qoi.make_mechanism(n_species, n_reactions, seed)
    b = r_qoi.make_mechanism(n_species, n_reactions, seed)
    for f in ("nu_fwd", "nu_rev", "log_a", "beta", "ea", "ds", "dh", "mol_weight"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert a.density == b.density


@pytest.mark.parametrize("n_species", [8, 58])
@pytest.mark.parametrize("perturb", [0.0, 1e-3])
def test_production_rates_match_the_reference(qoi_fields, n_species, perturb):
    """fp32 against the reference's fp32, on the field and on a perturbed
    reconstruction of it (clipped at 0, as the benchmarks feed it)."""
    y, temp = qoi_fields[n_species]
    if perturb:
        rng = np.random.default_rng(1)
        y = np.clip(y + perturb * y.std(axis=(1, 2, 3), keepdims=True)
                    * rng.normal(size=y.shape), 0, None).astype(np.float32)
    mech = t_qoi.make_mechanism(n_species)
    got = t_qoi.production_rates_np(mech, y, temp, device="cpu")
    want = r_qoi.production_rates_np(r_qoi.make_mechanism(n_species), y, temp)
    assert want.dtype == np.float32  # JAX without x64 runs the map in fp32
    assert got.dtype == np.float32 and got.shape == want.shape == y.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = np.abs(want).max(axis=(1, 2, 3), keepdims=True)
    err = np.abs(got - want)
    assert (err <= QOI_RTOL * scale).all(), float((err / scale).max())


def test_production_rates_on_tensors_and_chunks(qoi_fields, monkeypatch):
    """Tensor inputs on the device give the host entry's values; a grid
    split over many launch groups agrees with one group."""
    y, temp = qoi_fields[8]
    mech = t_qoi.make_mechanism(8)
    host = t_qoi.production_rates_np(mech, y, temp, device="cpu")
    yt = torch.from_numpy(np.moveaxis(y, 0, -1).copy())
    out = t_qoi.production_rates(mech, yt, torch.from_numpy(temp), device="cpu")
    assert out.shape == temp.shape + (8,) and out.dtype == torch.float32
    assert np.moveaxis(out.numpy(), -1, 0).tobytes() == host.tobytes()
    monkeypatch.setattr(t_qoi, "_CHUNK", 97)
    chunked = t_qoi.production_rates_np(mech, y, temp, device="cpu")
    scale = np.abs(host).max(axis=(1, 2, 3), keepdims=True)
    assert (np.abs(chunked - host) <= QOI_RTOL * scale).all()


def test_production_rates_rejects_mismatched_inputs():
    mech = t_qoi.make_mechanism(4)
    with pytest.raises(ValueError, match="leading shape"):
        t_qoi.production_rates(mech, np.ones((5, 4), np.float32),
                               np.ones(6, np.float32), device="cpu")
    with pytest.raises(ValueError, match="device"):
        t_qoi.production_rates(mech, torch.ones(5, 4, device="meta"),
                               np.ones(5, np.float32), device="cpu")
