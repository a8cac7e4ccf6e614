"""The port's kernel-ops entry point against the JAX package's.

``repro_torch.kernels.ops`` carries the reference's six ``*_op`` names; on
the CPU (``device="cpu"``) they run the plain versions in
``repro_torch.kernels.ref``, whose CUDA kernels ``chip_smoke.py`` holds
against them on the card. Here, from the same numpy inputs:

* each plain version of the last five kernels (2D GBATC pair, block_quant,
  rglru_scan, rwkv6_scan) against the reference's Pallas function in
  interpret mode on the reference's own sweep (``tests/test_kernels.py``)
  with its tolerances: 1e-5 for the 2D pair, 1e-6 for block_quant, 2e-4
  for the scans (2e-3 at extreme decay, 1e-5 at tiny decay): the Pallas
  scans are the chunked form, which agrees with the serial recurrence only
  that far;
* each against the reference's jnp oracle: block_quant bitwise (the eager
  oracle divides as IEEE does; XLA's compiled kernel multiplies by the
  reciprocal of qmax and moves a scale by one ulp), the serial scans to
  1e-5 (relative and absolute: the per-step sums are taken in another
  order);
* the port's six ``*_op`` against the reference's six;
* the clamp of the decays to [1e-37, 1], which the TPU kernels apply and
  the jnp oracles do not: the port follows the TPU kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gae import reference_pallas_load  # noqa: F401  (module-scoped shim fixture)

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels.block_quant import block_quant as pallas_block_quant
from repro.kernels.gbatc_project import gbatc_correct as pallas_gbatc_correct
from repro.kernels.gbatc_project import gbatc_project as pallas_gbatc_project
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru_scan
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6_scan
from repro_torch.kernels import block_quant as bq_wrapper
from repro_torch.kernels import flash_attention as flash_wrapper
from repro_torch.kernels import gbatc_project as gbatc_wrapper
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rglru_wrapper
from repro_torch.kernels import rwkv6_scan as rwkv6_wrapper


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# -- block_quant -----------------------------------------------------------
BQ_SWEEP = [((64, 256), 64), ((3, 7, 128), 32), ((1024, 64), 64)]


def _bq_input(shape, seed=None):
    rng = np.random.default_rng(sum(shape) if seed is None else seed)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("n_bits", [4, 8])
@pytest.mark.parametrize("shape,block", BQ_SWEEP)
def test_block_quant_matches_pallas(shape, block, n_bits):
    x = _bq_input(shape)
    want, want_scale = pallas_block_quant(jnp.asarray(x), n_bits=n_bits,
                                          block=block, interpret=True)
    got, scale = ref.block_quant_ref(torch.from_numpy(x), n_bits=n_bits, block=block)
    assert got.dtype == torch.float32 and scale.dtype == torch.float32
    assert tuple(scale.shape) == shape[:-1] + (shape[-1] // block,)
    _close(got.numpy(), want, 1e-6)
    _close(scale.numpy(), want_scale, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_bits", [4, 8])
@pytest.mark.parametrize("shape,block", BQ_SWEEP)
def test_block_quant_equals_eager_oracle_bitwise(shape, block, n_bits, dtype):
    x = _bq_input(shape)
    want, want_scale = ref_oracles.block_quant_ref(
        jnp.asarray(x).astype(getattr(jnp, dtype)), n_bits=n_bits, block=block)
    got, scale = ref.block_quant_ref(torch.from_numpy(x).to(getattr(torch, dtype)),
                                     n_bits=n_bits, block=block)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))


def test_block_quant_error_within_half_bin():
    """The reference's bound (tests/test_kernels.py::test_quant_error_bounded):
    half a bin plus the fp32 rounding of the dequantising multiply."""
    x = torch.from_numpy(_bq_input((128, 128), seed=5))
    out, scale = ref.block_quant_ref(x, n_bits=8, block=64)
    bound = scale.repeat_interleave(64, dim=-1) * 0.5 + 2e-7 * x.abs() + 1e-9
    assert bool(((out - x).abs() <= bound).all())


# -- rglru_scan ------------------------------------------------------------
RGLRU_SWEEP = [(1, 64, 32, 16), (2, 128, 256, 64), (1, 100, 130, 32)]


def _rglru_inputs(b, t, w, seed):
    rng = np.random.default_rng(seed)
    a = _sigmoid(2.0 + rng.normal(size=(b, t, w)))
    return (a, rng.normal(size=(b, t, w)).astype(np.float32),
            rng.normal(size=(b, w)).astype(np.float32))


@pytest.mark.parametrize("b,t,w,chunk", RGLRU_SWEEP)
def test_rglru_matches_pallas(reference_pallas_load, b, t, w, chunk):  # noqa: F811
    a, bb, h0 = _rglru_inputs(b, t, w, seed=t + w)
    want, want_last = pallas_rglru_scan(*_j(a, bb, h0), chunk=chunk, interpret=True)
    got, last = ref.rglru_scan_ref(*_t(a, bb, h0))
    _close(got.numpy(), want, 2e-4)
    _close(last.numpy(), want_last, 2e-4)


@pytest.mark.parametrize("b,t,w,chunk", RGLRU_SWEEP)
def test_rglru_matches_serial_oracle(b, t, w, chunk):
    a, bb, h0 = _rglru_inputs(b, t, w, seed=t + w)
    want, want_last = ref_oracles.rglru_scan_ref(*_j(a, bb, h0))
    got, last = ref.rglru_scan_ref(*_t(a, bb, h0))
    assert got.dtype == torch.float32 and last.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)
    _close(last.numpy(), want_last, 1e-5)


def test_rglru_tiny_decay_matches_pallas(reference_pallas_load):  # noqa: F811
    a = np.full((1, 32, 16), 1e-25, np.float32)
    bb = np.ones((1, 32, 16), np.float32)
    want, _ = pallas_rglru_scan(*_j(a, bb), chunk=8, interpret=True)
    got, _ = ref.rglru_scan_ref(*_t(a, bb))
    assert bool(torch.isfinite(got).all())
    _close(got.numpy(), want, 1e-5)


def test_rglru_clamps_decay_like_the_tpu_kernel(reference_pallas_load):  # noqa: F811
    """a > 1 is outside the contract; the TPU kernel clamps it to 1 and the
    jnp oracle does not. The port computes the TPU kernel's function."""
    a, bb, h0 = _rglru_inputs(1, 40, 16, seed=11)
    a[:, 10:20] = 1.5
    want, _ = pallas_rglru_scan(*_j(a, bb, h0), chunk=8, interpret=True)
    got, _ = ref.rglru_scan_ref(*_t(a, bb, h0))
    _close(got.numpy(), want, 2e-4)
    unclamped, _ = ref_oracles.rglru_scan_ref(*_j(a, bb, h0))
    assert np.abs(got.numpy() - np.asarray(unclamped)).max() > 1.0


# -- rwkv6_scan ------------------------------------------------------------
RWKV_SWEEP = [(1, 32, 1, 16, 8), (2, 64, 2, 32, 16), (1, 100, 2, 64, 32),
              (1, 128, 4, 64, 64)]


def _rwkv_inputs(b, t, h, n, seed, s0=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, n)).astype(np.float32) for _ in range(3))
    w = np.clip(_sigmoid(3.0 * rng.normal(size=(b, t, h, n))), 1e-6, 1 - 1e-6)
    u = (0.5 * rng.normal(size=(h, n))).astype(np.float32)
    out = [r, k, v, w.astype(np.float32), u]
    if s0:  # not symmetric: a transposed state would not pass
        out.append(rng.normal(size=(b, h, n, n)).astype(np.float32))
    return out


@pytest.mark.parametrize("b,t,h,n,chunk", RWKV_SWEEP)
def test_rwkv6_matches_pallas(reference_pallas_load, b, t, h, n, chunk):  # noqa: F811
    args = _rwkv_inputs(b, t, h, n, seed=t + n)
    want, want_state = pallas_rwkv6_scan(*_j(*args), chunk=chunk, interpret=True)
    got, state = ref.rwkv6_scan_ref(*_t(*args))
    _close(got.numpy(), want, 2e-4)
    _close(state.numpy(), want_state, 2e-4)


@pytest.mark.parametrize("b,t,h,n,chunk", RWKV_SWEEP)
def test_rwkv6_matches_serial_oracle(b, t, h, n, chunk):
    args = _rwkv_inputs(b, t, h, n, seed=t + n, s0=True)
    want, want_state = ref_oracles.rwkv6_scan_ref(*_j(*args))
    got, state = ref.rwkv6_scan_ref(*_t(*args))
    assert got.dtype == torch.float32 and state.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)
    _close(state.numpy(), want_state, 1e-5)


def test_rwkv6_extreme_decay_matches_pallas(reference_pallas_load):  # noqa: F811
    args = _rwkv_inputs(1, 64, 1, 16, seed=9)
    args[3] = np.full_like(args[3], 1e-30)
    want, _ = pallas_rwkv6_scan(*_j(*args), chunk=16, interpret=True)
    got, state = ref.rwkv6_scan_ref(*_t(*args))
    assert bool(torch.isfinite(got).all() & torch.isfinite(state).all())
    _close(got.numpy(), want, 2e-3)


def test_rwkv6_initial_state_carried(reference_pallas_load):  # noqa: F811
    """Rows of S over r/k/w, columns over v: the transposed initial state
    gives another answer, so the layout is pinned."""
    args = _rwkv_inputs(1, 32, 1, 16, seed=3, s0=True)
    want, want_state = pallas_rwkv6_scan(*_j(*args), chunk=8, interpret=True)
    got, state = ref.rwkv6_scan_ref(*_t(*args))
    _close(got.numpy(), want, 2e-4)
    _close(state.numpy(), want_state, 2e-4)
    flipped = args[:5] + [np.ascontiguousarray(args[5].transpose(0, 1, 3, 2))]
    other, _ = ref.rwkv6_scan_ref(*_t(*flipped))
    assert np.abs(other.numpy() - np.asarray(want)).max() > 1e-2


def test_rwkv6_clamps_decay_like_the_tpu_kernel(reference_pallas_load):  # noqa: F811
    args = _rwkv_inputs(1, 24, 2, 16, seed=12)
    args[3][:, 4:12] = 1.5
    want, _ = pallas_rwkv6_scan(*_j(*args), chunk=8, interpret=True)
    got, _ = ref.rwkv6_scan_ref(*_t(*args))
    _close(got.numpy(), want, 2e-4)
    unclamped, _ = ref_oracles.rwkv6_scan_ref(*_j(*args))
    assert np.abs(got.numpy() - np.asarray(unclamped)).max() > 1e-2


# -- the 2D GBATC pair -----------------------------------------------------
GBATC_SWEEP = [(100, 80), (1000, 80), (64, 64), (513, 80)]


def _gbatc_inputs(nb, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nb, d)).astype(np.float32)
    x_rec = (x + 0.1 * rng.normal(size=(nb, d))).astype(np.float32)
    q = np.linalg.qr(rng.normal(size=(d, d)))[0].astype(np.float32)
    return x, x_rec, q


@pytest.mark.parametrize("nb,d", GBATC_SWEEP)
def test_gbatc_project_matches_pallas(nb, d):
    x, _, q = _gbatc_inputs(nb, d, seed=nb)
    want = pallas_gbatc_project(*_j(x, q), interpret=True)
    got = ref.gbatc_project_ref(*_t(x, q))
    assert got.dtype == torch.float32 and tuple(got.shape) == (nb, d)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("nb,d", GBATC_SWEEP)
def test_gbatc_correct_matches_pallas(nb, d):
    x, x_rec, q = _gbatc_inputs(nb, d, seed=nb + 1)
    c = (x - x_rec) @ q
    mask = (np.abs(c) > np.quantile(np.abs(c), 0.5)).astype(np.float32)
    want = pallas_gbatc_correct(*_j(x_rec, c, mask, q), interpret=True)
    got = ref.gbatc_correct_ref(*_t(x_rec, c, mask, q))
    _close(got.numpy(), want, 1e-5)
    # a bool mask is the same mask
    same = ref.gbatc_correct_ref(*_t(x_rec, c, mask.astype(bool), q))
    np.testing.assert_array_equal(same.numpy(), got.numpy())


def test_gbatc_correct_all_ones_mask_reconstructs_x():
    x, x_rec, q = _gbatc_inputs(200, 80, seed=7)
    c = ref.gbatc_project_ref(*_t(x - x_rec, q))
    full = ref.gbatc_correct_ref(torch.from_numpy(x_rec), c, torch.ones_like(c),
                                 torch.from_numpy(q))
    _close(full.numpy(), x, 1e-4)


def test_gbatc_2d_computes_in_the_promoted_dtype():
    """fp32 operands with an fp64 basis compute in fp64, as the Pallas
    kernel's ``jnp.result_type`` (under x64) would."""
    x, x_rec, q = _gbatc_inputs(33, 16, seed=8)
    q64 = q.astype(np.float64)
    got = ref.gbatc_project_ref(*_t(x, q64))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), x.astype(np.float64) @ q64)
    mask = np.ones_like(x, dtype=bool)
    out = ref.gbatc_correct_ref(*_t(x_rec, x, mask, q64))
    assert out.dtype == torch.float64


# -- the six *_op against the reference's ----------------------------------
def _op_cases():
    rng = np.random.default_rng(42)
    q, k, v = (rng.normal(size=(1, 2, 128, 32)).astype(np.float32) for _ in range(3))
    rwkv = _rwkv_inputs(1, 64, 2, 32, seed=13, s0=True)
    a, bb, h0 = _rglru_inputs(2, 100, 130, seed=14)
    xq = _bq_input((64, 256), seed=15)
    x, x_rec, basis = _gbatc_inputs(513, 80, seed=16)
    c = (x - x_rec) @ basis
    mask = (rng.random(size=c.shape) < 0.5).astype(np.float32)
    return {
        "flash_attention_op": ((q, k, v), dict(causal=True, block_q=64, block_k=64), 2e-5),
        "rwkv6_scan_op": (tuple(rwkv), dict(chunk=16), 2e-4),
        "rglru_scan_op": ((a, bb, h0), dict(chunk=32, block_w=128), 2e-4),
        "block_quant_op": ((xq,), dict(n_bits=4, block=64, rows_per_tile=16), 1e-6),
        "gbatc_project_op": ((x - x_rec, basis), dict(rows_per_tile=128), 1e-5),
        "gbatc_correct_op": ((x_rec, c, mask, basis), dict(rows_per_tile=128), 1e-5),
    }


@pytest.mark.parametrize("name", ["flash_attention_op", "rwkv6_scan_op", "rglru_scan_op",
                                  "block_quant_op", "gbatc_project_op", "gbatc_correct_op"])
def test_op_matches_the_reference_op(reference_pallas_load, name):  # noqa: F811
    args, kwargs, tol = _op_cases()[name]
    want = getattr(ref_ops, name)(*_j(*args), **kwargs)
    got = getattr(ops, name)(*args, **kwargs, device="cpu")
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.numpy(), w, tol)


def test_ops_on_cpu_run_the_plain_versions():
    cases = _op_cases()
    plain = {"rwkv6_scan_op": ref.rwkv6_scan_ref, "rglru_scan_op": ref.rglru_scan_ref,
             "gbatc_project_op": ref.gbatc_project_ref,
             "gbatc_correct_op": ref.gbatc_correct_ref}
    for name, fn in plain.items():
        args, kwargs, _ = cases[name]
        got = getattr(ops, name)(*args, **kwargs, device="cpu")
        want = fn(*_t(*args))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    (xq,), kwargs, _ = cases["block_quant_op"]
    got = ops.block_quant_op(xq, n_bits=4, block=64, device="cpu")
    want = ref.block_quant_ref(torch.from_numpy(xq), n_bits=4, block=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("name,bad", [("rglru_scan_op", dict(chunk=0)),
                                      ("rglru_scan_op", dict(block_w="128")),
                                      ("rwkv6_scan_op", dict(chunk=-32)),
                                      ("block_quant_op", dict(rows_per_tile=True)),
                                      ("gbatc_project_op", dict(rows_per_tile=0.5)),
                                      ("flash_attention_op", dict(block_q=0))])
def test_tile_keywords_must_be_positive_ints(name, bad):
    args, _, _ = _op_cases()[name]
    with pytest.raises(ValueError, match="positive int"):
        getattr(ops, name)(*args, **bad, device="cpu")


# -- refusals --------------------------------------------------------------
def test_new_cuda_wrappers_refuse_cpu_tensors():
    """No silent fallback: the kernel wrappers take CUDA tensors only."""
    x, x_rec, q = _t(*_gbatc_inputs(8, 16, seed=1))
    a, bb, h0 = _t(*_rglru_inputs(1, 4, 8, seed=2))
    rwkv = _t(*_rwkv_inputs(1, 4, 1, 16, seed=3))
    calls = [
        lambda: gbatc_wrapper.gbatc_project(x, q),
        lambda: gbatc_wrapper.gbatc_correct(x_rec, x, torch.ones_like(x), q),
        lambda: bq_wrapper.block_quant(x, n_bits=8, block=16),
        lambda: rglru_wrapper.rglru_scan(a, bb, h0),
        lambda: rwkv6_wrapper.rwkv6_scan(*rwkv),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    assert gbatc_wrapper.launch_counts()["gbatc_project"] == 0
    assert gbatc_wrapper.launch_counts()["gbatc_correct"] == 0
    assert bq_wrapper.launch_counts() == {"block_quant": 0}
    assert rglru_wrapper.launch_counts() == {"rglru_scan": 0}
    assert rwkv6_wrapper.launch_counts() == {"rwkv6_scan": 0}


def test_out_of_range_shapes_raise():
    # the 2D pair takes any D >= 1; an empty block is refused
    x, q = torch.zeros(8, 0), torch.zeros(0, 0)
    with pytest.raises(ValueError, match="D=0: the kernels take D >= 1"):
        gbatc_wrapper.gbatc_project(x, q)
    with pytest.raises(ValueError, match="D=0: the kernels take D >= 1"):
        gbatc_wrapper.gbatc_correct(x, x, torch.ones_like(x), q)
    # rwkv6_scan takes any head size N >= 1: N = 0 is refused, N = 65 (past
    # the 64 of RWKV-6 7B) runs, here as its plain version
    with pytest.raises(ValueError, match="N=0: the kernel takes N >= 1"):
        rwkv6_wrapper.rwkv6_scan(*_t(*_rwkv_inputs(1, 4, 1, 0, seed=5)))
    args = _rwkv_inputs(1, 4, 1, 65, seed=5)
    for got, want in zip(ops.rwkv6_scan_op(*args, device="cpu"), ref.rwkv6_scan_ref(*_t(*args))):
        assert tuple(got.shape) == tuple(want.shape) and torch.equal(got, want)
    # flash takes any head dim D >= 1: D = 0 is refused, D = 257 (past every
    # configuration's 256) runs
    qz = torch.zeros(1, 1, 4, 0)
    with pytest.raises(ValueError, match="D=0: the kernel takes D >= 1"):
        flash_wrapper.flash_attention(qz, qz, qz)
    q = np.random.default_rng(8).normal(size=(1, 2, 5, 257)).astype(np.float32)
    got = ops.flash_attention_op(q, q, q, device="cpu")
    assert tuple(got.shape) == (1, 2, 5, 257)
    assert torch.equal(got, ref.flash_attention_ref(*_t(q, q, q)))
    xq = _bq_input((4, 96), seed=6)
    with pytest.raises(ValueError, match="multiple of block"):
        bq_wrapper.block_quant(torch.from_numpy(xq), block=64)
    with pytest.raises(ValueError, match="multiple of block"):
        ref.block_quant_ref(torch.from_numpy(xq), block=64)
    with pytest.raises(ValueError, match="multiple of block"):
        ops.block_quant_op(xq, block=64, device="cpu")
    with pytest.raises(ValueError, match="n_bits"):
        ops.block_quant_op(xq, n_bits=1, block=32, device="cpu")
