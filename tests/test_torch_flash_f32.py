"""The arithmetic of the fp32 flash kernels past D = 32 (``flash_f32_3xtf32``
to D = 256, ``flash_wide_mma`` past it, in ``kernels/csrc/flash_attention.cu``),
emulated in plain torch on the CPU, and the fp32 route's dispatch read from
the source.

The kernel runs only on the card; what can be held here is its numerical
design. The emulation repeats it step by step: q pre-scaled by ``scale *
log2(e)`` in fp32; every operand of both products split as ``x = hi + lo``
with ``hi`` rounded as ``cvt.rna.tf32.f32`` rounds (to 10 stored mantissa
bits, ties away from zero) and ``lo = x - hi`` as the tensor cores read it
(the same 10 bits, rounded toward zero); each 8-wide k-step of a product
accumulated as ``a_lo b_hi``, then ``a_hi b_lo``, then ``a_hi b_hi`` in
fp32; the kernel's row and key tiles (``tiles``) with its visited range and
masks (-1e30, the ragged tail -inf); one online-softmax correction a tile;
``P`` split like any operand; ``acc / max(l, 1e-30)``. Past D = 256
(``emulate_wide``) the scores of a (row tile, key tile) are the sum, in
group order, of each warp group's partial product over its share of every
Q K^T item's head dims (``wide_tiles``: the kernel's rows and keys a tile,
its warp groups and its item width), every output column of a row using
that one normaliser.

It is held against the plain version, ``repro_torch.kernels.ref.
flash_attention_ref``, under ``chip_smoke.FLASH_LIMIT["float32"]`` = 2e-5
max abs (what the card holds the kernel to), and against the reference's
Pallas kernel in interpret mode at the sweep of ``test_torch_kernels.py``.
Single-pass TF32 (the ``a_hi b_hi`` product alone) misses that limit, which
is why the kernels run three products.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_flash
from repro_torch.kernels import ref
from test_torch_gae import reference_pallas_load  # noqa: F401  (fixture)

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
      / "flash_attention.cu")
LOG2E = np.float32(1.4426950408889634)
NEG_INF = -1e30
LIMIT = 2e-5  # chip_smoke.FLASH_LIMIT["float32"]
DPS = (64, 80, 128, 256)  # the kernel's instantiations


def padded_dim(d: int) -> int:
    return next(p for p in DPS if d <= p)


def tiles(dp: int) -> tuple[int, int]:
    """(query rows a CTA, keys a tile): 4 warps of 2 m-tiles of 16 rows to
    DP = 128, of 1 at 256 (``tf_mtiles``, ``tf_keys``)."""
    return (128 if dp <= 128 else 64), {64: 64, 80: 32, 128: 16, 256: 32}[dp]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 stored mantissa bits, ties
    away from zero (the low 13 bits of the result are 0)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """An fp32 operand as the tensor cores read it: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32_rz(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *, three: bool) -> torch.Tensor:
    """``c + a @ b`` as the kernel's k-steps of 8: each step adds a_lo b_hi,
    a_hi b_lo, a_hi b_hi (or a_hi b_hi alone: single-pass TF32) into c."""
    (ah, al), (bh, bl) = split(a), split(b)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if three:
            c = c + al[..., ks] @ bh[..., ks, :]
            c = c + ah[..., ks] @ bl[..., ks, :]
        c = c + ah[..., ks] @ bh[..., ks, :]
    return c


def emulate(q, k, v, *, causal: bool, window: int, three: bool = True):
    """The kernel's arithmetic on (B, H, T, D) fp32 tensors (past D = 256:
    ``emulate_wide``)."""
    b, h, tq, d = q.shape
    if d > 256:
        return emulate_wide(q, k, v, causal=causal, window=window, three=three)
    tk = k.shape[2]
    dp = padded_dim(d)
    rows_a_cta, kn = tiles(dp)
    pad = (0, dp - d)
    qscale = np.float32(np.float32(1.0 / math.sqrt(d)) * LOG2E)  # fp32, as passed
    qs = torch.nn.functional.pad(q, pad) * torch.tensor(qscale)
    kp, vp = (torch.nn.functional.pad(t, pad) for t in (k, v))
    out = torch.empty_like(q)
    skip = not (window > 0 and tq > tk + window - 1)
    for q0 in range(0, tq, rows_a_cta):
        rows = torch.arange(q0, min(q0 + rows_a_cta, tq))
        lo = max(0, q0 - window + 1) if window > 0 and skip else 0
        hi = min(tk, q0 + rows_a_cta) if causal else tk
        m = torch.full((b, h, len(rows)), NEG_INF)
        l = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), dp)
        for t in range(lo // kn, -(-hi // kn)):
            keys = torch.arange(t * kn, (t + 1) * kn)
            live = keys < tk
            kt = torch.where(live[:, None], kp[:, :, keys.clamp(max=tk - 1)], 0.0)
            vt = torch.where(live[:, None], vp[:, :, keys.clamp(max=tk - 1)], 0.0)
            s = product(qs[:, :, rows], kt.transpose(-1, -2),
                        torch.zeros(b, h, len(rows), kn), three=three)
            masked = torch.zeros(len(rows), kn, dtype=torch.bool)
            if causal:
                masked |= keys[None, :] > rows[:, None]
            if window > 0:
                masked |= keys[None, :] <= rows[:, None] - window
            s = torch.where(masked, NEG_INF, s)
            s = torch.where(live, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = product(p, vt, acc * corr[..., None], three=three)
            m = m_new
        out[:, :, rows] = (acc / l.clamp_min(1e-30)[..., None])[..., :d]
    return out


def wide_tiles() -> tuple[int, int, int, int]:
    """``flash_wide_mma<float>``'s (query rows a CTA, keys a tile, warp
    groups, head dims a Q K^T item): ``WM_ROWS``, ``WM_KEYS``, 2 ``MT`` and
    ``Wide<float>::PK``."""
    return 64, 32, 4, 64


def emulate_wide(q, k, v, *, causal: bool, window: int, three: bool = True):
    """``flash_wide_mma``'s arithmetic on (B, H, T, D) fp32 tensors, D > 256:
    group gg's partial scores run over head dims p PK + gg PK / G ... of
    every Q K^T item p, 8 a k-step, and the scores are their sum in group
    order; P V as at D <= 256 (its output columns are independent)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    rows_a_cta, kn, groups, pk = wide_tiles()
    gk = pk // groups
    npq = -(-d // pk)
    qscale = np.float32(np.float32(1.0 / math.sqrt(d)) * LOG2E)
    qs = torch.nn.functional.pad(q, (0, npq * pk - d)) * torch.tensor(qscale)
    kp = torch.nn.functional.pad(k, (0, npq * pk - d))
    dims = [torch.tensor([p * pk + gg * gk + i for p in range(npq) for i in range(gk)])
            for gg in range(groups)]
    out = torch.empty_like(q)
    skip = not (window > 0 and tq > tk + window - 1)
    for q0 in range(0, tq, rows_a_cta):
        rows = torch.arange(q0, min(q0 + rows_a_cta, tq))
        lo = max(0, q0 - window + 1) if window > 0 and skip else 0
        hi = min(tk, q0 + rows_a_cta) if causal else tk
        m = torch.full((b, h, len(rows)), NEG_INF)
        l = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), d)
        for t in range(lo // kn, -(-hi // kn)):
            keys = torch.arange(t * kn, (t + 1) * kn)
            live = keys < tk
            kt = torch.where(live[:, None], kp[:, :, keys.clamp(max=tk - 1)], 0.0)
            vt = torch.where(live[:, None], v[:, :, keys.clamp(max=tk - 1)], 0.0)
            s = None
            for idx in dims:
                part = product(qs[:, :, rows][..., idx], kt[..., idx].transpose(-1, -2),
                               torch.zeros(b, h, len(rows), kn), three=three)
                s = part if s is None else s + part
            masked = torch.zeros(len(rows), kn, dtype=torch.bool)
            if causal:
                masked |= keys[None, :] > rows[:, None]
            if window > 0:
                masked |= keys[None, :] <= rows[:, None] - window
            s = torch.where(masked, NEG_INF, s)
            s = torch.where(live, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = product(p, vt, acc * corr[..., None], three=three)
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out


def qkv(b, h, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32))
            for t in (tq, tk, tk)]


def test_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # a tf32 ulp at [1, 2)
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -23, 1.0 + 3 * one_ulp / 2])
    want = torch.tensor([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + 2 * one_ulp])
    assert torch.equal(tf32(x), want)
    assert torch.equal(tf32_rz(x), torch.tensor([1.0, 1.0, -1.0, 1.0, 1.0 + one_ulp]))
    hi, lo = split(torch.tensor([math.pi], dtype=torch.float32))
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32_rz(lo), lo)
    assert abs(float(hi) + float(lo) - float(np.float32(math.pi))) <= 2.0 ** -21 * math.pi


# (b, h, tq, tk, d, causal, window): causal, windowed, ragged Tk, non-causal
# and rows with no live key, at D = 64, 80, 96, 128 and 256
CASES = [
    (1, 2, 192, 192, 64, True, 0),
    (2, 1, 70, 100, 64, False, 0),
    (1, 2, 200, 200, 80, True, 40),
    (2, 1, 130, 77, 80, False, 0),
    (1, 2, 130, 130, 96, True, 0),
    (1, 1, 150, 77, 96, True, 50),
    (1, 1, 70, 300, 128, False, 24),
    (2, 1, 160, 160, 128, True, 0),
    (1, 1, 130, 130, 256, True, 48),
    (1, 1, 100, 37, 256, False, 0),
    (2, 1, 77, 150, 37, True, 0),
]


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_emulation_within_the_fp32_limit(case):
    b, h, tq, tk, d, causal, window = case
    q, k, v = qkv(b, h, tq, tk, d, seed=tq + tk + d + window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = emulate(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= LIMIT


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: on one thread they do not wait for the threads of
    the other pytest workers that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# past D = 256 (flash_wide_mma): causal, windowed with rows that have no
# live key, ragged Tk, non-causal, a partial Q K^T item (D = 257, 1000)
# and two output slabs (D = 1000)
WIDE_CASES = [
    (1, 2, 70, 70, 257, True, 0),
    (2, 1, 100, 77, 320, False, 0),
    (1, 1, 77, 130, 384, True, 50),
    (1, 1, 96, 40, 512, True, 24),
    (1, 1, 70, 100, 1000, False, 0),
]


@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_3xtf32_emulation_within_the_fp32_limit(case):
    b, h, tq, tk, d, causal, window = case
    q, k, v = qkv(b, h, tq, tk, d, seed=tq + tk + d + window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = emulate(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= LIMIT


@pytest.mark.parametrize("d", [64, 128, 256, 320])
def test_single_pass_tf32_misses_the_limit(d):
    q, k, v = qkv(1, 2, 128, 128, d, seed=d)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=0)
    three = float((emulate(q, k, v, causal=True, window=0) - want).abs().max())
    single = float((emulate(q, k, v, causal=True, window=0, three=False) - want).abs().max())
    assert three <= LIMIT < single
    assert single > 10 * three


# the reference's sweep past D = 32 (test_torch_kernels.FLASH_SWEEP, the
# (b, h, tq, tk, d, causal, window, block_q, block_k) entries), D = 256
# and one head past it
PALLAS_CASES = [
    (1, 1, 128, 128, 64, True, 0, 128, 128),
    (2, 3, 256, 256, 64, True, 0, 128, 128),
    (1, 2, 128, 384, 128, True, 0, 128, 128),
    (1, 2, 256, 256, 64, True, 16, 128, 128),
    (1, 1, 128, 256, 64, False, 0, 128, 128),
    (1, 2, 128, 128, 256, True, 32, 64, 64),
    (1, 1, 128, 128, 320, True, 40, 64, 64),
]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_3xtf32_emulation_matches_pallas(reference_pallas_load, case):  # noqa: F811
    b, h, tq, tk, d, causal, window, bq, bk = case
    q, k, v = qkv(b, h, tq, tk, d, seed=tq + tk + d + window)
    want = ref_flash.flash_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal, window=window,
        block_q=bq, block_k=bk, interpret=True)
    got = emulate(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LIMIT, atol=LIMIT)


def _dispatch(launcher: str) -> list[tuple[int | None, str]]:
    """``launcher``'s branches in order: (largest D, launcher), the last
    one (None, launcher) for every larger D."""
    body = re.search(rf"int {launcher}\(.*?\n}}\n", CU.read_text(), re.S).group(0)
    steps = re.findall(r"if \(d <= (\d+)\)\s+return (\w+<[^>]+>)", body)
    last = re.findall(r"\n  return (\w+<[^>]+>)\(", body)
    return [(int(n), fn) for n, fn in steps] + [(None, last[-1])]


def _fp32_dispatch() -> list[tuple[int | None, str]]:
    return _dispatch("launch_f32")


def _source_value(function: str, dp: int) -> int:
    """The value of ``function<DP>()`` in the source: its return expression,
    a chain of C conditionals on DP, evaluated at ``dp``."""
    expr = re.search(function + r"\(\) \{\s*return (.*?);", CU.read_text(), re.S).group(1)

    def value(e: str) -> int:
        if "?" not in e:
            return int(eval(e, {"DP": dp}))
        cond, rest = e.split("?", 1)
        then, other = rest.split(":", 1)
        return value(then) if eval(cond, {"DP": dp}) else value(other)

    return value(" ".join(expr.split()))


@pytest.mark.parametrize("dp", DPS)
def test_emulated_tiles_are_the_kernels(dp):
    rows, keys = tiles(dp)
    assert rows == 16 * 4 * _source_value("tf_mtiles", dp)
    assert keys == _source_value("tf_keys", dp)


def wide_constants(dtype: str) -> dict:
    """``flash_wide_mma``'s tile constants read from the source: WM_WARPS,
    WM_ROWS, WM_KEYS, WM_SLAB and ``Wide<dtype>``'s MT, PK and PVG."""
    text = CU.read_text()
    out = {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
           for name in ("WM_WARPS", "WM_ROWS", "WM_KEYS", "WM_SLAB")}
    body = re.search(rf"struct Wide<{dtype}> \{{(.*?)\}};", text, re.S).group(1)
    for name in ("MT", "PK", "PVG"):
        out[name] = int(re.search(rf"\b{name} = (\d+)", body).group(1))
    return out


def test_wide_emulated_tiles_are_the_kernels():
    c = wide_constants("float")
    rows, keys, groups, pk = wide_tiles()
    assert (rows, keys, pk) == (c["WM_ROWS"], c["WM_KEYS"], c["PK"])
    # 8 warps in groups of 4 / MT; a group's share of an item is whole k-steps
    assert c["WM_WARPS"] == 8 and groups == c["WM_WARPS"] // (4 // c["MT"])
    assert pk % (8 * groups) == 0 and c["WM_SLAB"] % (groups * c["PVG"]) == 0


def test_fp32_dispatch_keeps_the_codec_kernel_to_d32():
    routes = _fp32_dispatch()
    assert routes == [(16, "launch_as<float, 16>"), (32, "launch_as<float, 32>"),
                      (64, "launch_3xtf32<64>"), (80, "launch_3xtf32<80>"),
                      (128, "launch_3xtf32<128>"), (256, "launch_3xtf32<256>"),
                      (None, "launch_wide_mma<float>")]
    # the emulation pads D as the dispatch does, up to 256; past it every D
    # runs flash_wide_mma (emulate_wide)
    for d in range(33, 257):
        want = next(n for n, _ in routes if n is not None and d <= n)
        assert padded_dim(d) == want
