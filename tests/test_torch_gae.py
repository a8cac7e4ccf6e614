"""The port's guarantee engine vs the numpy oracle and the reference engine.

Same ``(x, x_rec)`` from seeded numpy through ``repro_torch.core.gae``
(host select and device select, both on the CPU), the numpy oracle
``repro.core.gae_ref`` and the reference ``GuaranteeEngine``: quantised
coefficients, CSR offsets/indices and the stored basis must be **equal**,
projections agree to rtol 1e-12 (fp64, different summation order), and
every block meets tau.

The reference engine imports ``enable_x64`` from ``jax.experimental``,
which the installed JAX no longer has. :func:`reference_x64` puts the name
there for the duration of one test module and removes it again, so files
that do not ask for it see the reference exactly as it is checked in.
:func:`reference_pallas_load` does the same for ``pallas.load`` and
``pallas.store``, which the reference's flash-attention kernel calls.
"""

import contextlib

import jax
import jax.experimental
import numpy as np
import pytest

from repro.core import gae as r_gae
from repro.core import gae_ref
from repro_torch.core import gae as t_gae


@contextlib.contextmanager
def reference_x64_shim():
    """Give ``jax.experimental`` the ``enable_x64`` name the reference
    engine looks up at call time; take it away again on exit."""
    had = "enable_x64" in vars(jax.experimental)
    if not had:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        yield
    finally:
        if not had:
            del jax.experimental.enable_x64


@pytest.fixture(scope="module")
def reference_x64():
    with reference_x64_shim():
        yield


@contextlib.contextmanager
def pallas_load_shim():
    """Give ``jax.experimental.pallas`` the ``load`` / ``store`` names the
    reference's flash-attention kernel calls; take them away again on
    exit."""
    from jax.experimental import pallas as pl

    added = [n for n in ("load", "store") if n not in vars(pl)]
    if "load" in added:
        pl.load = lambda ref, idx: ref[idx]
    if "store" in added:
        pl.store = lambda ref, idx, val: ref.__setitem__(idx, val)
    try:
        yield
    finally:
        for n in added:
            delattr(pl, n)


@pytest.fixture(scope="module")
def reference_pallas_load():
    with pallas_load_shim():
        yield


def _case(seed, s=3, nb=160, d=80, noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, nb, d)).astype(np.float32)
    x_rec = (x + noise * rng.normal(size=(s, nb, d))).astype(np.float32)
    return x, x_rec


def _assert_same_artifact(a, b):
    np.testing.assert_array_equal(a.coeff_q, b.coeff_q)
    np.testing.assert_array_equal(a.index_offsets, b.index_offsets)
    np.testing.assert_array_equal(a.index_flat, b.index_flat)
    np.testing.assert_array_equal(a.basis, b.basis)
    assert a.coeff_bin == b.coeff_bin and a.tau == b.tau


def _max_block_residual(x, corrected):
    r = x.astype(np.float64) - corrected
    return np.sqrt((r ** 2).sum(-1)).max()


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("tau", [0.1, 0.5, 2.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_numpy_oracle(backend, tau, seed):
    x, x_rec = _case(seed, nb=300 if seed else 160)
    eng = t_gae.GuaranteeEngine("cpu", select_backend=backend)
    corrected, arts = eng.select(eng.prepare(x, x_rec), tau)
    assert corrected.dtype == np.float32
    assert _max_block_residual(x, corrected) <= tau + 1e-4
    for s in range(x.shape[0]):
        want_c, want = gae_ref.guarantee(x[s], x_rec[s], tau)
        _assert_same_artifact(arts[s], want)
        np.testing.assert_allclose(corrected[s], want_c, atol=1e-6)
        assert t_gae.verify_guarantee(x[s], corrected[s], tau)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_matches_reference_engine(reference_x64, backend):
    x, x_rec = _case(2)
    ref_eng = r_gae.GuaranteeEngine()
    ref_prep = ref_eng.prepare(x, x_rec)
    eng = t_gae.GuaranteeEngine("cpu", select_backend=backend)
    prep = eng.prepare(x, x_rec)
    np.testing.assert_array_equal(prep.basis, ref_prep.basis)
    np.testing.assert_array_equal(prep.norms2, ref_prep.norms2)
    np.testing.assert_allclose(prep.coeffs, ref_prep.coeffs, rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal(prep.inv_rank, ref_prep.inv_rank)
    for tau in (0.1, 0.4):
        ref_c, ref_arts = ref_eng.select(ref_prep, tau)
        c, arts = eng.select(prep, tau)
        for a, b in zip(arts, ref_arts):
            _assert_same_artifact(a, b)
        np.testing.assert_allclose(c, ref_c, atol=1e-6)
        assert _max_block_residual(x, c) <= tau * (1 + 1e-6)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_matches_reference_engine_at_d512(reference_x64, backend):
    """A codec's 8 x 8 x 8 block (D = 512): the basis, the ranks and every
    artifact equal the reference engine's, the coefficients to rtol 1e-12.
    More blocks than D, as a codec has (1600 a species on the card's
    path): with fewer, most coefficients are rounding noise and their
    ranks are not defined."""
    x, x_rec = _case(5, s=2, nb=600, d=512)
    ref_eng = r_gae.GuaranteeEngine()
    ref_prep = ref_eng.prepare(x, x_rec)
    eng = t_gae.GuaranteeEngine("cpu", select_backend=backend)
    prep = eng.prepare(x, x_rec)
    assert prep.shape == (2, 600, 512)
    np.testing.assert_array_equal(prep.basis, ref_prep.basis)
    np.testing.assert_array_equal(prep.inv_rank, ref_prep.inv_rank)
    np.testing.assert_allclose(prep.coeffs, ref_prep.coeffs, rtol=1e-12,
                               atol=1e-14)
    for tau in (0.5, 2.0):
        ref_c, ref_arts = ref_eng.select(ref_prep, tau)
        c, arts = eng.select(prep, tau)
        for a, b in zip(arts, ref_arts, strict=True):
            _assert_same_artifact(a, b)
        np.testing.assert_allclose(c, ref_c, atol=1e-6)
        assert _max_block_residual(x, c) <= tau * (1 + 1e-6)


def test_shim_is_scoped_to_the_fixture():
    """Outside the fixture's module scope nothing is patched: the shim
    context restores ``jax.experimental`` to what it was."""
    before = "enable_x64" in vars(jax.experimental)
    with reference_x64_shim():
        from jax.experimental import enable_x64  # noqa: F401
    assert ("enable_x64" in vars(jax.experimental)) == before


def test_pallas_shim_is_scoped_to_the_fixture():
    """``tests/test_kernels.py`` sees ``pallas.load`` / ``pallas.store``
    exactly as the installed JAX has them once the shim context exits."""
    from jax.experimental import pallas as pl

    from repro.kernels import flash_attention as r_flash

    before = {n: n in vars(pl) for n in ("load", "store")}
    with pallas_load_shim():
        assert r_flash.pl is pl and callable(pl.load) and callable(pl.store)
    assert {n: n in vars(pl) for n in ("load", "store")} == before


def test_reuse_equals_cold_prepare():
    x, x_rec = _case(3, s=4)
    eng = t_gae.GuaranteeEngine("cpu", select_backend="device")
    first = eng.prepare(x, x_rec)
    assert eng.prepare(x, x_rec.copy(), reuse=first) is first
    changed = x_rec.copy()
    changed[[1, 3]] += np.float32(0.01)
    warm = eng.prepare(x, changed, reuse=first)
    cold = eng.prepare(x, changed)
    for name in ("norms2", "basis", "coeffs", "coeffs_sorted", "inv_rank"):
        np.testing.assert_array_equal(getattr(warm, name), getattr(cold, name))
    np.testing.assert_array_equal(warm.coeffs_dev.numpy(), cold.coeffs_dev.numpy())
    cw, aw = eng.select(warm, 0.2)
    cc, ac = eng.select(cold, 0.2)
    np.testing.assert_array_equal(cw, cc)
    for a, b in zip(aw, ac):
        _assert_same_artifact(a, b)


def test_loose_bound_stores_nothing():
    x, x_rec = _case(4, noise=0.01)
    eng = t_gae.GuaranteeEngine("cpu")
    corrected, arts = eng.select(eng.prepare(x, x_rec), 1e6)
    assert all(a.coeff_q.size == 0 and a.basis.shape[1] == 0 for a in arts)
    np.testing.assert_array_equal(corrected, x_rec)


def test_coarse_bin_is_clamped():
    x, x_rec = _case(5)
    corrected, arts = t_gae.guarantee_batched(x, x_rec, 0.3, coeff_bin=100.0,
                                              device="cpu")
    assert _max_block_residual(x, corrected) <= 0.3 + 1e-4
    assert all(a.coeff_bin <= 1.8 * 0.3 / np.sqrt(80) + 1e-12 for a in arts)


@pytest.mark.parametrize("block_range", [None, (40, 120)])
def test_decode_replay_matches(block_range):
    x, x_rec = _case(6)
    eng = t_gae.GuaranteeEngine("cpu")
    corrected, arts = eng.select(eng.prepare(x, x_rec), 0.4)
    if block_range is None:
        np.testing.assert_array_equal(eng.apply_batched(x_rec, arts), corrected)
        np.testing.assert_allclose(
            t_gae.apply_correction(x_rec[0], arts[0]), corrected[0], atol=1e-6)
    else:
        b0, b1 = block_range
        s, _, d = x.shape
        full, basis = eng.dense_corrections(arts, x.shape)
        win, basis_w = eng.dense_corrections(arts, (s, b1 - b0, d),
                                             block_range=block_range)
        np.testing.assert_array_equal(win, full[:, b0:b1])
        np.testing.assert_array_equal(basis_w, basis)
        out = eng.apply_device(eng._stage(x_rec[:, b0:b1]), win, basis_w)
        np.testing.assert_array_equal(out.numpy(), corrected[:, b0:b1])


def test_wire_parts_roundtrip_and_reference_bytes(reference_x64):
    x, x_rec = _case(7, s=2)
    _, arts = t_gae.guarantee_batched(x, x_rec, 0.2, device="cpu")
    _, ref_arts = r_gae.guarantee_batched(x, x_rec, 0.2)
    for a, b in zip(arts, ref_arts):
        assert a.wire_parts() == b.wire_parts()
        assert a.to_bytes() == b.to_bytes()
        back = t_gae.GuaranteeArtifact.from_bytes(b.to_bytes())
        _assert_same_artifact(back, a)
        assert a.total_bytes() == b.total_bytes()
    coeff, index, basis = arts[0].wire_parts()
    with pytest.raises(Exception) as err:
        t_gae.GuaranteeArtifact.from_parts(
            0.2, arts[0].coeff_bin, 80, arts[0].basis.shape[1],
            coeff[: len(coeff) // 2], index, basis)
    assert type(err.value).__name__ == "ContainerFormatError"


def test_default_engine_needs_cuda_or_explicit_cpu():
    import torch

    assert t_gae.default_engine("cpu") is t_gae.default_engine("cpu")
    assert t_gae.default_engine("cpu").select_backend == "host"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_gae.GuaranteeEngine()
        with pytest.raises(RuntimeError, match="CUDA"):
            t_gae.default_engine()
