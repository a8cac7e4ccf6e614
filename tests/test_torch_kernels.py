"""Port kernels' plain PyTorch versions vs the reference Pallas functions.

The CUDA kernels themselves only run on a GPU (``chip_smoke.py`` holds each
against its plain version there). Here the plain versions — what
``repro_torch.kernels.ops`` runs for CPU tensors — are held against the
reference's Pallas kernels in interpret mode on the reference's own shape
sweep, from the same numpy inputs: fp32 to atol 1e-5 (different summation
order of 80..130 products of unit-scale values), fp64 to rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gbatc_project as ref_kernels
from repro_torch.kernels import gbatc_project as cuda_wrappers
from repro_torch.kernels import ops, ref

SWEEP = [
    (3, 100, 80, None, None, None),   # single grid step
    (2, 513, 130, 1, 256, 128),       # ragged rows, padding on every axis
    (1, 7, 4, None, None, None),      # tiny everything
    (5, 64, 80, 2, 16, 8),            # species tiling + row tiling
    (2, 513, 64, None, None, None),   # D = 64, ragged rows
]


def _inputs(s, nb, d, dtype=np.float32, seed=None):
    rng = np.random.default_rng(1000 * s + nb + d if seed is None else seed)
    x = rng.normal(size=(s, nb, d)).astype(dtype)
    c = rng.normal(size=(s, nb, d)).astype(dtype)
    u = np.stack([np.linalg.qr(rng.normal(size=(d, d)))[0]
                  for _ in range(s)]).astype(dtype)
    rank = np.argsort(np.argsort(-np.abs(c), axis=-1), axis=-1).astype(np.int32)
    m = rng.integers(0, d + 1, size=(s, nb)).astype(np.int32)
    return x, c, u, rank, m


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("s,nb,d,spt,rpt,lane", SWEEP)
def test_project_matches_pallas(s, nb, d, spt, rpt, lane):
    x, _, u, _, _ = _inputs(s, nb, d)
    want = ref_kernels.gbatc_project_batched(
        jnp.asarray(x), jnp.asarray(u), species_per_tile=spt,
        rows_per_tile=rpt, interpret=True, lane=lane)
    got = ref.gbatc_project_batched_ref(*_t(x, u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("s,nb,d,spt,rpt,lane", SWEEP)
def test_correct_matches_pallas(s, nb, d, spt, rpt, lane):
    x, c, u, _, _ = _inputs(s, nb, d)
    want = ref_kernels.gbatc_correct_batched(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(u), species_per_tile=spt,
        rows_per_tile=rpt, interpret=True, lane=lane)
    got = ref.gbatc_correct_batched_ref(*_t(x, c, u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("s,nb,d,spt,rpt,lane", SWEEP)
def test_select_accumulate_matches_pallas(s, nb, d, spt, rpt, lane):
    x, c, u, rank, m = _inputs(s, nb, d)
    want = ref_kernels.gbatc_select_accumulate(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(rank), jnp.asarray(m),
        jnp.asarray(u), species_per_tile=spt, rows_per_tile=rpt,
        interpret=True, lane=lane)
    got = ref.gbatc_select_accumulate_ref(*_t(x, c, rank, m, u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_select_accumulate_m_zero_is_identity():
    x, c, _, _, _ = _inputs(2, 64, 80)
    u = np.stack([np.eye(80, dtype=np.float32)] * 2)
    rank = np.broadcast_to(np.arange(80, dtype=np.int32), (2, 64, 80)).copy()
    m = np.zeros((2, 64), np.int32)
    got = ref.gbatc_select_accumulate_ref(*_t(x, c, rank, m, u))
    np.testing.assert_array_equal(got.numpy(), x)


def test_select_with_full_cut_equals_correct():
    x, c, u, rank, _ = _inputs(3, 50, 80)
    m = np.full((3, 50), 80, np.int32)
    a = ref.gbatc_select_accumulate_ref(*_t(x, c, rank, m, u))
    b = ref.gbatc_correct_batched_ref(*_t(x, c, u))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kernel", ["project", "correct", "select"])
def test_fp64_matches_pallas(kernel):
    """The engine runs the projection in fp64; dtype is honoured end to end
    and agrees with the reference kernel to rtol 1e-12."""
    x, c, u, rank, m = _inputs(2, 50, 80, dtype=np.float64, seed=0)
    with jax.enable_x64():
        if kernel == "project":
            want = ref_kernels.gbatc_project_batched(
                jnp.asarray(x), jnp.asarray(u), interpret=True)
            got = ref.gbatc_project_batched_ref(*_t(x, u))
        elif kernel == "correct":
            want = ref_kernels.gbatc_correct_batched(
                jnp.asarray(x), jnp.asarray(c), jnp.asarray(u), interpret=True)
            got = ref.gbatc_correct_batched_ref(*_t(x, c, u))
        else:
            want = ref_kernels.gbatc_select_accumulate(
                jnp.asarray(x), jnp.asarray(c), jnp.asarray(rank),
                jnp.asarray(m), jnp.asarray(u), interpret=True)
            got = ref.gbatc_select_accumulate_ref(*_t(x, c, rank, m, u))
        assert want.dtype == jnp.float64
        want = np.asarray(want)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_ops_on_cpu_run_the_plain_versions():
    x, c, u, rank, m = _inputs(2, 33, 16)
    np.testing.assert_array_equal(
        ops.gbatc_project_batched(x, u, device="cpu").numpy(),
        ref.gbatc_project_batched_ref(*_t(x, u)).numpy())
    np.testing.assert_array_equal(
        ops.gbatc_correct_batched(x, c, u, device="cpu").numpy(),
        ref.gbatc_correct_batched_ref(*_t(x, c, u)).numpy())
    np.testing.assert_array_equal(
        ops.gbatc_select_accumulate(x, c, rank, m, u, device="cpu").numpy(),
        ref.gbatc_select_accumulate_ref(*_t(x, c, rank, m, u)).numpy())


def test_cuda_wrappers_refuse_cpu_tensors():
    """No silent fallback: the kernel wrappers take CUDA tensors only."""
    x, c, u, rank, m = _t(*_inputs(1, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_wrappers.gbatc_project_batched(x, u)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_wrappers.gbatc_correct_batched(x, c, u)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_wrappers.gbatc_select_accumulate(x, c, rank, m, u)
    assert cuda_wrappers.launch_counts() == {
        "gbatc_project_batched": 0, "gbatc_select_accumulate": 0,
        "gbatc_correct_batched": 0}


def test_ops_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, _, u, _, _ = _inputs(1, 8, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.gbatc_project_batched(x, u)
