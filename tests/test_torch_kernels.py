"""Port kernels' plain PyTorch versions vs the reference Pallas functions.

The CUDA kernels themselves only run on a GPU (``chip_smoke.py`` holds each
against its plain version there). Here the plain versions — what
``repro_torch.kernels.ops`` runs for CPU tensors — are held against the
reference's Pallas kernels in interpret mode on the reference's own shape
sweep, from the same numpy inputs: fp32 to atol 1e-5 (different summation
order of 80..130 products of unit-scale values), fp64 to rtol 1e-12.
Flash attention uses the reference's own tolerances: 2e-5 in fp32, 2e-2 in
bf16 (both sides round the same fp32 inputs to bf16, compute in fp32 and
round the output once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gae import reference_pallas_load  # noqa: F401  (module-scoped shim fixture)

from repro.kernels import flash_attention as ref_flash
from repro.kernels import gbatc_project as ref_kernels
from repro.kernels import ref as ref_oracles
from repro_torch.kernels import flash_attention as flash_wrapper
from repro_torch.kernels import gbatc_project as cuda_wrappers
from repro_torch.kernels import ops, ref

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: on one thread they do not wait for the threads of
    the other pytest workers that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# -- wide blocks, 128 < D <= 256 (the weight checkpoint's D = 256) ---------
WIDE = [(2, 100, 129), (1, 70, 200), (2, 33, 256)]


@pytest.mark.parametrize("s,nb,d", WIDE)
def test_wide_project_fp64_matches_pallas(s, nb, d):
    """The route the engine takes at D = 256: fp64, rtol 1e-12."""
    x, _, u, _, _ = _inputs(s, nb, d, dtype=np.float64)
    with jax.enable_x64():
        want = np.asarray(ref_kernels.gbatc_project_batched(
            jnp.asarray(x), jnp.asarray(u), interpret=True))
    got = ref.gbatc_project_batched_ref(*_t(x, u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("s,nb,d", WIDE)
def test_wide_select_accumulate_matches_pallas(s, nb, d):
    x, c, u, rank, m = _inputs(s, nb, d)
    want = ref_kernels.gbatc_select_accumulate(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(rank), jnp.asarray(m),
        jnp.asarray(u), interpret=True)
    got = ref.gbatc_select_accumulate_ref(*_t(x, c, rank, m, u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("s,nb,d", WIDE)
def test_wide_correct_matches_pallas(s, nb, d):
    x, c, u, _, _ = _inputs(s, nb, d)
    want = ref_kernels.gbatc_correct_batched(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(u), interpret=True)
    got = ref.gbatc_correct_batched_ref(*_t(x, c, u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# -- any D: past every panel and slab of the kernels ----------------------
# (2, 33, 130) is the reference's own 130, (1, 20, 257) one past a
# 256-column slab, (2, 9, 512) a codec's 8 x 8 x 8 block
ANY_D = [(2, 33, 130), (1, 20, 257), (2, 9, 512)]


def _batched(kernel, arrays, pallas):
    """The batched kernel on (x, c, u, rank, m): the reference's Pallas
    function in interpret mode, or the port's plain version."""
    x, c, u, rank, m = (jnp.asarray(a) for a in arrays) if pallas else _t(*arrays)
    if pallas:
        fn = {"project": lambda: ref_kernels.gbatc_project_batched(x, u, interpret=True),
              "correct": lambda: ref_kernels.gbatc_correct_batched(x, c, u, interpret=True),
              "select": lambda: ref_kernels.gbatc_select_accumulate(
                  x, c, rank, m, u, interpret=True)}[kernel]
        return np.asarray(fn())
    return {"project": lambda: ref.gbatc_project_batched_ref(x, u),
            "correct": lambda: ref.gbatc_correct_batched_ref(x, c, u),
            "select": lambda: ref.gbatc_select_accumulate_ref(x, c, rank, m, u)}[kernel]()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kernel", ["project", "correct", "select"])
@pytest.mark.parametrize("s,nb,d", ANY_D)
def test_any_d_matches_pallas(s, nb, d, kernel, dtype):
    """fp64 under x64 to rtol 1e-12, fp32 to atol 1e-5, as at D <= 256."""
    arrays = _inputs(s, nb, d, dtype=dtype)
    got = _batched(kernel, arrays, pallas=False)
    assert got.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    if dtype == np.float64:
        with jax.enable_x64():
            want = _batched(kernel, arrays, pallas=True)
        assert want.dtype == np.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    else:
        want = _batched(kernel, arrays, pallas=True)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kernel", ["project", "correct"])
@pytest.mark.parametrize("nb,d", [(33, 130), (9, 512)])
def test_2d_pair_any_d_matches_pallas(nb, d, kernel, dtype):
    x, c, u, _, _ = (a[0] for a in _inputs(1, nb, d, dtype=dtype))
    mask = (np.random.default_rng(d).random((nb, d)) < 0.5).astype(dtype)

    def pallas():
        if kernel == "project":
            return np.asarray(ref_kernels.gbatc_project(
                jnp.asarray(x), jnp.asarray(u), interpret=True))
        return np.asarray(ref_kernels.gbatc_correct(
            *(jnp.asarray(a) for a in (x, c, mask, u)), interpret=True))

    got = (ref.gbatc_project_ref(*_t(x, u)) if kernel == "project"
           else ref.gbatc_correct_ref(*_t(x, c, mask, u)))
    if dtype == np.float64:
        with jax.enable_x64():
            want = pallas()
        assert got.dtype == torch.float64 and want.dtype == np.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_allclose(got.numpy(), pallas(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [129, 257, 513, 1000])
@pytest.mark.parametrize("kernel,dtype", [
    ("gbatc_project_batched", torch.float64),
    ("gbatc_select_accumulate", torch.float32),
    ("gbatc_correct_batched", torch.float32),
    ("gbatc_project_batched", torch.float32),
    ("gbatc_select_accumulate", torch.float64),
    ("gbatc_correct_batched", torch.float64),
])
def test_wrapper_d_limit_per_route(kernel, dtype, d):
    """Every route takes any D >= 1: past 128, 256 and 512 a wrapper goes
    on to refuse the CPU tensor, and D = 0 raises ValueError (before the
    device check, so on the CPU too)."""
    def call(d):
        x, c, u, rank, m = (t.to(dtype) if t.is_floating_point() else t
                            for t in _t(*_inputs(1, 4, d)))
        fn = getattr(cuda_wrappers, kernel)
        if kernel == "gbatc_project_batched":
            return fn(x, u)
        if kernel == "gbatc_correct_batched":
            return fn(x, c, u)
        return fn(x, c, rank, m, u)

    with pytest.raises(ValueError, match="CUDA tensors only"):
        call(d)
    with pytest.raises(ValueError, match=r"D=0: the kernels take D >= 1$"):
        call(0)
    assert cuda_wrappers.launch_counts()[kernel] == 0


def test_2d_pair_takes_every_d_past_128():
    """The 2D pair no longer stops at D = 128, in fp64 or fp32: past 128,
    256 and 512 it goes on to refuse the CPU tensor, and D = 0 raises
    ValueError."""
    for dtype in (torch.float64, torch.float32):
        for d in (129, 257, 513, 1000, 0):
            x, c, u = (t[0].to(dtype) for t in _t(*_inputs(1, 4, d)[:3]))
            want = ("CUDA tensors only" if d else
                    r"D=0: the kernels take D >= 1$")
            with pytest.raises(ValueError, match=want):
                cuda_wrappers.gbatc_project(x, u)
            with pytest.raises(ValueError, match=want):
                cuda_wrappers.gbatc_correct(x, c, torch.ones_like(x), u)
    counts = cuda_wrappers.launch_counts()
    assert counts["gbatc_project"] == counts["gbatc_correct"] == 0


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
        "gbatc_correct_batched": 0, "gbatc_project": 0, "gbatc_correct": 0}


def test_ops_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, _, u, _, _ = _inputs(1, 8, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.gbatc_project_batched(x, u)


# -- flash attention -------------------------------------------------------
# (b, h, tq, tk, d, causal, window, block_q, block_k): the reference's sweep
# in tests/test_kernels.py, then the codec's own non-causal shape at small
# batch with a block that divides Tk = 232 (the reference cannot run it
# with its default block of 128, see test_flash_ragged_tk_*)
FLASH_SWEEP = [
    (1, 1, 128, 128, 64, True, 0, 128, 128),
    (2, 3, 256, 256, 64, True, 0, 128, 128),
    (1, 2, 128, 384, 128, True, 0, 128, 128),
    (1, 1, 200, 200, 64, True, 0, 128, 128),
    (2, 2, 64, 64, 32, True, 0, 128, 128),
    (1, 2, 256, 256, 64, True, 16, 128, 128),
    (1, 2, 256, 256, 64, True, 64, 128, 128),
    (1, 2, 256, 256, 64, True, 1000, 128, 128),
    (1, 1, 128, 256, 64, False, 0, 128, 128),
    (1, 2, 256, 256, 64, True, 0, 64, 64),
    (1, 2, 256, 256, 64, True, 0, 128, 256),
    (1, 2, 256, 256, 64, True, 0, 32, 128),
    (2, 2, 232, 232, 16, False, 0, 8, 8),
]


def _qkv(b, h, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, tq, d)).astype(np.float32),
            rng.normal(size=(b, h, tk, d)).astype(np.float32),
            rng.normal(size=(b, h, tk, d)).astype(np.float32))


# the reference sweeps bf16 on its five causal shapes only
FLASH_CASES = [(c, "float32") for c in FLASH_SWEEP] + [
    (c, "bfloat16") for c in FLASH_SWEEP[:5]]


@pytest.mark.parametrize("case,dtype", FLASH_CASES)
def test_flash_ref_matches_pallas(reference_pallas_load, case, dtype):  # noqa: F811
    b, h, tq, tk, d, causal, window, bq, bk = case
    q, k, v = _qkv(b, h, tq, tk, d, seed=tq + tk + d + window)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_flash.flash_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
        window=window, block_q=bq, block_k=bk, interpret=True)
    got = ref.flash_attention_ref(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        window=window)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, tq, d)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# head dim 256 (RecurrentGemma-2B's local attention), causal with a window,
# Tk a multiple of the reference's block_k (ROADMAP C-ref-2)
FLASH_D256 = [(1, 2, 128, 128, 256, True, 32, 64, 64),
              (2, 1, 64, 64, 256, True, 100, 32, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_D256)
def test_flash_ref_matches_pallas_d256(reference_pallas_load, case, dtype):  # noqa: F811
    b, h, tq, tk, d, causal, window, bq, bk = case
    q, k, v = _qkv(b, h, tq, tk, d, seed=d + window)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_flash.flash_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
        window=window, block_q=bq, block_k=bk, interpret=True)
    got = ref.flash_attention_ref(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        window=window)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, tq, d)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,tq,tk,d", [(2, 2, 232, 232, 16), (3, 2, 1, 16, 16),
                                         (1, 2, 100, 37, 64)])
def test_flash_ragged_tk_matches_reference_oracle(b, h, tq, tk, d):
    """Non-causal with Tk not a multiple of the reference's block: its
    Pallas wrapper refuses (it cannot mask a padded key tail when not
    causal), the port's plain version takes it and agrees with the
    reference's jnp oracle to 2e-5."""
    q, k, v = _qkv(b, h, tq, tk, d, seed=7 + tk)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if tk > 128 and tk % 128:
        with pytest.raises(NotImplementedError, match="Tk % block_k"):
            ref_flash.flash_attention(jq, jk, jv, causal=False, block_k=128,
                                      interpret=True)
    want = ref_oracles.flash_attention_ref(jq, jk, jv, causal=False)
    got = ref.flash_attention_ref(*_t(q, k, v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_fully_masked_keys_carry_no_weight():
    """Keys outside a causal window get weight 0: perturbing them leaves
    the output bitwise unchanged."""
    q, k, v = _qkv(1, 2, 64, 64, 16, seed=3)
    a = ref.flash_attention_ref(*_t(q, k, v), causal=True, window=8)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, :40] += 5.0
    v2[:, :, :40] -= 3.0
    b = ref.flash_attention_ref(*_t(q, k2, v2), causal=True, window=8)
    np.testing.assert_array_equal(a[:, :, 47:].numpy(), b[:, :, 47:].numpy())


def test_ops_flash_on_cpu_runs_the_plain_version():
    q, k, v = _qkv(2, 2, 20, 20, 8, seed=4)
    np.testing.assert_array_equal(
        ops.flash_attention(q, k, v, causal=False, device="cpu").numpy(),
        ref.flash_attention_ref(*_t(q, k, v), causal=False).numpy())


def test_flash_wrapper_refuses_cpu_tensors():
    q, k, v = _t(*_qkv(1, 1, 8, 8, 16, seed=5))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_wrapper.flash_attention(q, k, v)
    assert flash_wrapper.launch_counts() == {"flash_attention": 0}


def test_ops_flash_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, k, v = _qkv(1, 1, 8, 8, 16, seed=6)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention(q, k, v)
