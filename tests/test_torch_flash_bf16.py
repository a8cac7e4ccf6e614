"""The arithmetic of the bf16 flash kernels (``flash_bf16_mma`` to D = 256,
``flash_wide_mma`` past it, in ``kernels/csrc/flash_attention.cu``),
emulated in plain torch on the CPU.

The kernel runs only on the card; what can be held here is its numerical
design. The emulation below repeats it step by step: bf16 operands, fp32
scores (products of bf16 values are exact in fp32), ``scale * log2(e)``
applied to the fp32 score, the kernel's tiles of 64 query rows and 64 keys
(32 at a padded head dim of 256) with the same visited range and masks,
one online-softmax correction a tile, ``l`` summed from the fp32 ``p``, and
``P V`` as a bf16 pair ``P_hi = bf16(p)``, ``P_lo = bf16(p - P_hi)`` with
fp32 accumulate; the output is rounded to bf16 once. Past D = 256
(``flash_wide_mma``: 64 query rows and 32 keys a tile) the fp32 score is
the sum, in group order, of each warp group's partial product over its
share of every Q K^T item's head dims, scaled once.

It is held against the plain version, ``repro_torch.kernels.ref.
flash_attention_ref``, under the gate ``chip_smoke.py`` applies on the card
at every bf16 element: |kernel - plain| <= 2^-7 |plain| + 4e-5 (one bf16
ulp of the value plus twice the fp32 limit). A row whose weighted sum
cancels is planted: there the single-rounding variant (P rounded to bf16
once, the textbook FlashAttention-2 step) misses the gate by far and the
pair meets it, which is why the kernel runs two P V products.
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

LOG2E = np.float32(1.4426950408889634)
NEG_INF = -1e30
ROWS = 64  # query rows per CTA
GATE_ULP, GATE_ABS = 2.0 ** -7, 4e-5
CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
      / "flash_attention.cu")
# flash_wide_mma<bf16>: keys a tile, warp groups (2 MT), head dims a Q K^T item
WIDE_KEYS, WIDE_GROUPS, WIDE_PK = 32, 2, 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: on one thread they do not wait for the threads of
    the other pytest workers that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def emulate(q, k, v, *, causal: bool, window: int, split: bool = True):
    """The kernel's arithmetic on (B, H, T, D) bf16 tensors; returns bf16."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    wide = d > 256
    if wide:  # flash_wide_mma: partial scores over each group's dims
        kn = WIDE_KEYS
        gk, npq = WIDE_PK // WIDE_GROUPS, -(-d // WIDE_PK)
        dims = [torch.tensor([i for p in range(npq) for i in
                              range(p * WIDE_PK + gg * gk, p * WIDE_PK + (gg + 1) * gk)
                              if i < d]) for gg in range(WIDE_GROUPS)]
    else:
        dp = next(p for p in (16, 32, 64, 80, 128, 256) if d <= p)
        kn = 64 if dp <= 128 else 32
    sl2 = float(np.float32(1.0 / math.sqrt(d)) * LOG2E)  # fp32 scale * log2(e)
    qf, kf, vf = (t.float() for t in (q, k, v))
    out = torch.empty_like(q)
    skip = not (window > 0 and tq > tk + window - 1)
    for q0 in range(0, tq, ROWS):
        rows = torch.arange(q0, min(q0 + ROWS, tq))
        lo = max(0, q0 - window + 1) if window > 0 and skip else 0
        hi = min(tk, q0 + ROWS) if causal else tk
        m = torch.full((b, h, len(rows)), NEG_INF)
        l = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), d)
        for t in range(lo // kn, -(-hi // kn)):
            keys = torch.arange(t * kn, (t + 1) * kn)
            live = keys < tk
            kt = torch.where(live[:, None], kf[:, :, keys.clamp(max=tk - 1)], 0.0)
            vt = torch.where(live[:, None], vf[:, :, keys.clamp(max=tk - 1)], 0.0)
            if wide:
                s = sum(qf[:, :, rows][..., idx] @ kt[..., idx].transpose(-1, -2)
                        for idx in dims) * sl2
            else:
                s = (qf[:, :, rows] @ kt.transpose(-1, -2)) * sl2
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
            p_hi = p.bfloat16().float()
            acc = acc * corr[..., None] + p_hi @ vt
            if split:
                acc = acc + (p - p_hi).bfloat16().float() @ vt
            m = m_new
        out[:, :, rows] = (acc / l.clamp_min(1e-30)[..., None]).bfloat16()
    return out


def ulp_ratio(got, want):
    """|got - want| / (2^-7 |want| + 4e-5), elementwise."""
    return (got.float() - want.float()).abs() / (GATE_ULP * want.float().abs() + GATE_ABS)


def inputs(b, h, tq, tk, d, seed, plant):
    """Unit-normal bf16 q, k, v; with ``plant``, query row 1 of (batch 0,
    head 0) sees keys 0 and 1 (causal) with weights 1 and p_b = exp(-2 /
    sqrt(D)), and head dim 0 of their values cancels: 8 p_b + bf16(-8 p_b)
    leaves only the rounding of that value, so |o| is about 2^-9 of
    sum p|v| / l there."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32))
               for t in (tq, tk, tk))
    if plant:
        q[0, 0, 1] = 0.0
        q[0, 0, 1, 0] = 1.0
        k[0, 0, :2] = 0.0
        k[0, 0, 0, 0] = 2.0
        v[0, 0, 1, 0] = 8.0
        v[0, 0, 0, 0] = float(torch.tensor(-8.0 * math.exp(-2.0 / math.sqrt(d))).bfloat16())
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


# (b, h, tq, tk, d, causal, window): causal, causal under windows, ragged
# non-causal at padded head dims, a window over a ragged tail, and D = 256
CASES = [
    (1, 2, 192, 192, 64, True, 0),
    (1, 2, 200, 200, 80, True, 40),
    (2, 1, 70, 100, 80, False, 0),
    (1, 1, 70, 300, 128, False, 24),
    (1, 2, 100, 37, 8, False, 0),
    (1, 1, 130, 130, 256, True, 48),
]


@pytest.mark.parametrize("case", CASES)
def test_pair_emulation_meets_the_bf16_gate(case):
    b, h, tq, tk, d, causal, window = case
    q, k, v = inputs(b, h, tq, tk, d, seed=tq + tk + d, plant=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = emulate(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert float(ulp_ratio(got, want).max()) <= 1.0


# past D = 256 (flash_wide_mma): causal with the planted row, a window with
# rows that have no live key, ragged non-causal, a partial Q K^T item
# (D = 257, 1000) and two output slabs (D = 1000)
WIDE_CASES = [
    (1, 2, 70, 70, 257, True, 0),
    (2, 1, 100, 77, 320, False, 0),
    (1, 1, 77, 130, 384, True, 50),
    (1, 1, 96, 40, 512, True, 24),
    (1, 1, 70, 100, 1000, False, 0),
]


@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_pair_emulation_meets_the_bf16_gate(case):
    b, h, tq, tk, d, causal, window = case
    q, k, v = inputs(b, h, tq, tk, d, seed=tq + tk + d, plant=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = emulate(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert float(ulp_ratio(got, want).max()) <= 1.0


def test_wide_emulation_matches_pallas(reference_pallas_load):  # noqa: F811
    """One head past 256 against the reference's Pallas kernel in
    interpret mode, to its bf16 tolerance (test_torch_wide.py)."""
    q, k, v = inputs(1, 1, 128, 128, 320, seed=7, plant=False)
    want = ref_flash.flash_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)),
        causal=True, window=40, block_q=64, block_k=64, interpret=True)
    got = emulate(q, k, v, causal=True, window=40)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("d", [64, 80, 128, 320])
def test_single_rounding_misses_the_gate_on_a_cancelling_row(d):
    q, k, v = inputs(1, 1, 96, 96, d, seed=d, plant=True)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=0)
    pair = ulp_ratio(emulate(q, k, v, causal=True, window=0), want)
    single = ulp_ratio(emulate(q, k, v, causal=True, window=0, split=False), want)
    assert float(pair.max()) <= 1.0
    assert float(single[0, 0, 1, 0]) > 1.0  # the planted element


def test_bf16_dispatch_runs_the_emulated_tiles_to_d256():
    """``launch_bf16``'s branches, read from the source: the padded dims the
    emulation above takes up to D = 256, then ``flash_wide_mma`` (tensor
    cores, the wide branch of the emulation) for every larger D."""
    body = re.search(r"int launch_bf16\(.*?\n}\n", CU.read_text(), re.S).group(0)
    steps = re.findall(r"if \(d <= (\d+)\)\s+return (\w+<[^>]+>)", body)
    last = re.findall(r"\n  return (\w+<[^>]+>)\(", body)
    assert [(int(n), fn) for n, fn in steps] + [(None, last[-1])] == [
        (16, "launch_mma<16>"), (32, "launch_mma<32>"), (64, "launch_mma<64>"),
        (80, "launch_mma<80>"), (128, "launch_mma<128>"), (256, "launch_mma<256>"),
        (None, "launch_wide_mma<bf16>")]


def test_wide_emulated_tiles_are_the_kernels():
    """The wide branch's keys a tile, warp groups and Q K^T item width are
    ``flash_wide_mma<bf16>``'s (WM_KEYS, 2 MT, ``Wide<bf16>::PK``), and so
    are its 64 rows a CTA."""
    text = CU.read_text()
    body = re.search(r"struct Wide<bf16> \{(.*?)\};", text, re.S).group(1)
    mt = int(re.search(r"\bMT = (\d+)", body).group(1))
    assert int(re.search(r"\bPK = (\d+)", body).group(1)) == WIDE_PK
    assert int(re.search(r"constexpr int WM_KEYS = (\d+);", text).group(1)) == WIDE_KEYS
    assert int(re.search(r"constexpr int WM_ROWS = (\d+);", text).group(1)) == ROWS
    assert 2 * mt == WIDE_GROUPS and WIDE_PK % (16 * WIDE_GROUPS) == 0
