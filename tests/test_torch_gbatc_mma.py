"""The arithmetic of the GBATC kernels past D = 128 (``gbatc_wide_3xtf32``
and ``gbatc_wide_dmma`` in ``kernels/csrc/gbatc_kernels.cu``), emulated in
plain torch on the CPU.

The kernels run only on the card; what can be held here is their numerical
design. ``emulate_3xtf32`` repeats the fp32 kernel step by step: every
operand split as ``x = hi + lo`` (``test_torch_flash_f32.split``: hi rounded
as ``cvt.rna.tf32.f32`` rounds, lo as the tensor cores read ``x - hi``);
k padded with +0 to a multiple of ``WT_KP`` = 16, a k pair of two m16n8k8
steps, the first over k = 16 p + 4 q + {0, 1}, the second over 16 p + 4 q +
{2, 3} (q < 4); each step adds ``a_lo b_hi``, ``a_hi b_lo`` and ``a_hi
b_hi`` to a partial sum of the pair that starts at +0, and the partial is
added to the accumulator, all in fp32 (the tensor cores truncate as they
accumulate, so a long chain of MMAs into one accumulator drifts: the
partial keeps each chain to one k pair); out = x + acc, the projection
acc. Select and the
masked mode feed it ``c`` with +0 where ``rank >= m`` or ``c * mask``.
``emulate_dmma`` repeats the fp64 kernel: k padded with +0 to a multiple
of 8, each 8-wide step's products summed in fp64 into the accumulator,
steps ascending from +0, out = x + acc.

Each is held against the plain version (``repro_torch.kernels.ref``) at
ragged wide shapes under ``chip_smoke.FP32_LIMIT`` = 1e-5 max abs and
``FP64_REL_LIMIT`` = 1e-12 of the row's l2 norm (what the card holds the
kernels to), and against the reference's Pallas kernels in interpret mode;
single-pass TF32 (``a_hi b_hi`` alone) misses the fp32 limit, which is why
the kernel runs three products. The weight checkpoint's gate
(``tests/test_torch_train.py``, ``chip_smoke.py``'s ``lm_train_path``)
holds on the emulated select. The tile constants and the slab split are
read from the source.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_f32 import split, tf32, tf32_rz
from test_torch_gae import reference_pallas_load, reference_x64  # noqa: F401  (fixtures)

from repro.kernels import gbatc_project as ref_kernels
from repro_torch.kernels import ops, ref
from repro_torch.train.checkpoint import compress_state_bytes

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
      / "gbatc_kernels.cu")
FP32_LIMIT = 1e-5        # chip_smoke.FP32_LIMIT
FP64_REL_LIMIT = 1e-12   # chip_smoke.FP64_REL_LIMIT
PAIR = 16                # WT_KP: k a panel of the fp32 kernel, two m16n8k8 steps
STEP = 8                 # k a tensor-core step


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: on one thread they do not wait for the threads of
    the other pytest workers that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pair_steps(k: int) -> list[torch.Tensor]:
    """The k indices of each m16n8k8 step of the fp32 kernel, in order, over
    k padded to a multiple of PAIR."""
    out = []
    for p in range(-(-k // PAIR)):
        for s in (0, 1):
            out.append(torch.tensor([PAIR * p + 4 * q + 2 * s + e
                                     for q in range(4) for e in (0, 1)]))
    return out


def emulate_3xtf32(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor | None = None,
                   *, three: bool = True) -> torch.Tensor:
    """``x + a @ b`` (``a @ b`` where x is None) as gbatc_wide_3xtf32 computes
    it: a (..., NB, K), b (..., K, N), fp32. A k pair's products go into a
    partial sum from +0, each step a_lo b_hi, a_hi b_lo, a_hi b_hi (or a_hi
    b_hi alone: single-pass TF32), and the partial into the accumulator."""
    k = a.shape[-1]
    kp = -(-k // PAIR) * PAIR
    (ah, al), (bh, bl) = split(torch.nn.functional.pad(a, (0, kp - k))), split(
        torch.nn.functional.pad(b, (0, 0, 0, kp - k)))
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    steps = pair_steps(k)
    for first, second in zip(steps[::2], steps[1::2]):
        part = torch.zeros_like(acc)
        for ks in (first, second):
            if three:
                part = part + al[..., ks] @ bh[..., ks, :]
                part = part + ah[..., ks] @ bl[..., ks, :]
            part = part + ah[..., ks] @ bh[..., ks, :]
        acc = acc + part
    return acc if x is None else x + acc


def emulate_dmma(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x + a @ b`` as gbatc_wide_dmma computes it, fp64."""
    k = a.shape[-1]
    kp = -(-k // STEP) * STEP
    a = torch.nn.functional.pad(a, (0, kp - k))
    b = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    for k0 in range(0, kp, STEP):
        acc = acc + a[..., k0:k0 + STEP] @ b[..., k0:k0 + STEP, :]
    return x + acc


def kept(c, rank, m):
    return torch.where(rank < m[..., None], c, torch.zeros((), dtype=c.dtype))


def emulated(route: str, x, c, u, rank=None, m=None, mask=None, *, three=True):
    """The kernel's output for ``route`` (project, correct, select, masked):
    gbatc_wide_3xtf32 in fp32, gbatc_wide_dmma in fp64 (no projection: the
    fp64 projection stays on project_f64_wide)."""
    coeffs = {"project": x, "correct": c, "select": None, "masked": None}[route]
    if route == "select":
        coeffs = kept(c, rank, m)
    if route == "masked":
        coeffs = c * mask
    b = u if route == "project" else u.transpose(-1, -2)
    if x.dtype == torch.float64:
        assert route != "project"
        return emulate_dmma(coeffs, b, x)
    return emulate_3xtf32(coeffs, b, None if route == "project" else x, three=three)


def plain(route: str, x, c, u, rank=None, m=None, mask=None):
    if route == "project":
        return ref.gbatc_project_batched_ref(x, u)
    if route == "correct":
        return ref.gbatc_correct_batched_ref(x, c, u)
    if route == "select":
        return ref.gbatc_select_accumulate_ref(x, c, rank, m, u)
    return ref.gbatc_correct_ref(x[0], c[0], mask[0], u[0])[None]


def inputs(s, nb, d, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, nb, d))
    c = rng.normal(size=(s, nb, d))
    u = np.stack([np.linalg.qr(rng.normal(size=(d, d)))[0] for _ in range(s)])
    rank = np.argsort(np.argsort(-np.abs(c), axis=-1), axis=-1).astype(np.int32)
    m = rng.integers(0, d + 1, size=(s, nb)).astype(np.int32)
    mask = (rng.random((s, nb, d)) < 0.5)
    return ([a.astype(dtype) for a in (x, c, u)] + [rank, m, mask.astype(dtype)])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def max_err(got, want, rows) -> float:
    """chip_smoke.compare's measure: max abs (fp32), over the row's l2 norm
    (fp64)."""
    diff = (got - want).abs()
    if got.dtype == torch.float64:
        diff = diff / rows.norm(dim=-1, keepdim=True).clamp_min(1e-300)
    return float(diff.max())


# ragged rows at the wide D of chip_smoke's WIDE / ANY_D sweeps: one past
# 128, a partial k pair (200), one past a 256-column slab, one past 512,
# and three slabs of a partial last pair (1000)
SHAPES = [(2, 37, 129), (1, 45, 200), (2, 21, 257), (1, 19, 513), (1, 9, 1000)]


@pytest.mark.parametrize("route", ["project", "correct", "select", "masked"])
@pytest.mark.parametrize("s,nb,d", SHAPES)
def test_3xtf32_emulation_within_the_fp32_limit(s, nb, d, route):
    x, c, u, rank, m, mask = _t(*inputs(s if route != "masked" else 1, nb, d, seed=d + nb))
    got = emulated(route, x, c, u, rank, m, mask)
    want = plain(route, x, c, u, rank, m, mask)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert max_err(got, want, x) <= FP32_LIMIT


@pytest.mark.parametrize("route", ["correct", "select", "masked"])
@pytest.mark.parametrize("s,nb,d", SHAPES)
def test_dmma_emulation_within_the_fp64_limit(s, nb, d, route):
    x, c, u, rank, m, mask = _t(*inputs(s if route != "masked" else 1, nb, d,
                                        dtype=np.float64, seed=d + nb))
    got = emulated(route, x, c, u, rank, m, mask)
    want = plain(route, x, c, u, rank, m, mask)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert max_err(got, want, c) <= FP64_REL_LIMIT


@pytest.mark.parametrize("d", [129, 257, 513, 1000])
def test_single_pass_tf32_misses_the_limit(d):
    x, c, u, *_ = _t(*inputs(1, 64, d, seed=d))
    want = plain("correct", x, c, u)
    three = max_err(emulated("correct", x, c, u), want, x)
    single = max_err(emulated("correct", x, c, u, three=False), want, x)
    assert three <= FP32_LIMIT < single
    assert single > 10 * three


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("s,nb,d", SHAPES)
def test_select_is_correct_on_the_kept_coefficients_bitwise(s, nb, d, dtype):
    """Both modes feed the products the same operand bits, so the encode
    side's reconstruction and the decode side's replay agree bit for bit;
    the masked mode with the keep mask as its mask does too."""
    x, c, u, rank, m, _ = _t(*inputs(s, nb, d, dtype=dtype, seed=d))
    sel = emulated("select", x, c, u, rank, m)
    assert torch.equal(sel, emulated("correct", x, kept(c, rank, m), u))
    keep = (rank < m[..., None]).to(x.dtype)
    assert torch.equal(sel[:1], emulated("masked", x[:1], c[:1], u[:1], mask=keep[:1]))


# the reference's Pallas kernels in interpret mode (fp64 under x64), at a
# shape past a 256-column slab and one past 512 with a partial k pair
PALLAS_SHAPES = [(2, 33, 257), (1, 9, 520)]


@pytest.mark.parametrize("route", ["correct", "select"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("s,nb,d", PALLAS_SHAPES)
def test_emulation_matches_pallas(reference_x64, reference_pallas_load,  # noqa: F811
                                  s, nb, d, dtype, route):
    x, c, u, rank, m, _ = inputs(s, nb, d, dtype=dtype, seed=d + 1)

    def pallas():
        if route == "correct":
            return np.asarray(ref_kernels.gbatc_correct_batched(
                *(jnp.asarray(a) for a in (x, c, u)), interpret=True))
        return np.asarray(ref_kernels.gbatc_select_accumulate(
            *(jnp.asarray(a) for a in (x, c, rank, m, u)), interpret=True))

    got = emulated(route, *_t(x, c, u, rank, m)).numpy()
    if dtype == np.float64:
        with jax.enable_x64():
            want = pallas()
        assert want.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_allclose(got, pallas(), rtol=0, atol=FP32_LIMIT)


def test_split_is_the_kernels():
    """split_plane's hi is cvt.rna.tf32 (``tf32``), its lo the exact x - hi
    read to 19 bits by the tensor cores (``tf32_rz``), as ``split``."""
    body = re.search(r"void split_plane\(.*?\n}\n", CU.read_text(), re.S).group(0)
    assert "(__float_as_uint(x) + 0x1000u) & ~0x1fffu" in body
    assert "lo = __float_as_uint(x - __uint_as_float(hi));" in body
    v = torch.tensor([1.0 + 2.0 ** -11, -3.14159265, 7e-5], dtype=torch.float32)
    hi, lo = split(v)
    assert torch.equal(hi, tf32(v)) and torch.equal(lo, tf32_rz(v - hi))


def constants() -> dict:
    text = CU.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
            for name in ("WT_TM", "WT_SLAB", "WT_KP", "WD_KP", "WIDE_THREADS")}


def slab_width(d: int) -> int:
    """The source's slab_width, its C body evaluated on positive ints."""
    body = re.search(r"int slab_width\(int d\) \{(.*?)\n}", CU.read_text(), re.S).group(1)
    env = {"d": d, "WT_SLAB": constants()["WT_SLAB"]}
    for line in body.strip().splitlines():
        line = line.strip().rstrip(";").replace("/", "//")
        if line.startswith("return "):
            return eval(line[len("return "):], {}, env)
        name, expr = line.removeprefix("const int ").split(" = ", 1)
        env[name] = eval(expr, {}, env)
    raise AssertionError("slab_width has no return")


def test_emulated_tiles_are_the_kernels():
    """The emulation's k pair is the fp32 kernel's panel and its step the
    MMA's; a tile is 8 warps of 32 rows by up to 8 n fragments; the slabs
    of a D cover it evenly, at most WT_SLAB columns each, a warp's share of
    a slab whole fragments and at most 8 of them."""
    cst = constants()
    assert cst["WT_KP"] == PAIR == 2 * STEP and cst["WD_KP"] % STEP == 0
    warps_m = cst["WT_TM"] // 32
    warps_n = cst["WIDE_THREADS"] // 32 // warps_m
    assert warps_m * warps_n * 32 == cst["WIDE_THREADS"] == 256
    assert cst["WT_SLAB"] <= warps_n * 64
    for d in range(129, 1200):
        sw = slab_width(d)
        nsl = -(-d // cst["WT_SLAB"])
        assert sw % 8 == 0 and sw <= cst["WT_SLAB"] and nsl * sw >= d > (nsl - 1) * sw
        for jw in {sw, d - (nsl - 1) * sw}:
            nfs = -(-jw // 8)
            per = -(-nfs // warps_n)
            assert per <= 8 and warps_n * per >= nfs


def test_checkpoint_gate_holds_on_the_emulated_select(monkeypatch):
    """tests/test_torch_train.py's seeded weights at tau_rel 1e-3 with the
    engine's select (D = 256) computed as gbatc_wide_3xtf32 computes it:
    every 256-block within tau (1 + 1e-6) + 2^-24 |rec block|, the gate of
    chip_smoke.py's compressed checkpoint."""
    calls = []

    def select(x_rec, coeff_vals, rank, m, basis, *, device=None):
        calls.append(tuple(x_rec.shape))
        assert x_rec.dtype == torch.float32
        return emulated("select", x_rec, coeff_vals, basis, rank, m)

    monkeypatch.setattr(ops, "gbatc_select_accumulate", select)
    rng = np.random.default_rng(1)
    v = (rng.normal(size=(1024, 4096)) * 0.02
         + rng.normal(size=(1, 4096)) * 0.001).astype(np.float32)
    rec, _, report = compress_state_bytes({"w": v}, tau_rel=1e-3, device="cpu")
    assert calls and all(shape[-1] == 256 for shape in calls)
    blocks, rblocks = v.reshape(-1, 256), rec["w"].reshape(-1, 256)
    norms = np.linalg.norm(blocks - rblocks, axis=1)
    tau = 1e-3 * np.sqrt(np.mean(blocks**2)) * np.sqrt(256)
    assert (norms <= tau * (1 + 1e-6) + 2.0**-24 * np.linalg.norm(rblocks, axis=1)).all()
    assert report["ratio"] > 2.0
