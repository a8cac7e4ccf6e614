"""The arithmetic of ``rwkv6_chunked`` (``rwkv6_scan`` past N = 64, in
``kernels/csrc/rwkv6_scan.cu``), emulated in plain torch on the CPU.

The kernel runs only on the card; what can be held here is its numerical
design. ``emulate`` repeats it step by step: the state S (rows i, columns
j) walked in chunks of ``CK_C`` = 16 tokens (a ragged last chunk padded
with w = 1, r = k = v = 0); w clamped to [1e-37, 1]; within a chunk the
running products P_t = prod_{j<t} w_j and Q_t = prod_{t<j<C} w_j and L_t =
sum_{j<=t} log2 w_j; A (C x C) in 2 x 2 blocks, each taking one
exponential 2^(L_{t1-1} - L_{s2}) and the rest by its decays (the factored
exponentials of the chunked form: every factor a product of decays, so in
[0, 1]), the diagonal blocks' pair with no decay and the bonus r_t u k_t
on the diagonal; then

* out^T = S^T (r P)^T + v^T A^T, every product as 3xTF32 (x = hi + lo:
  ``test_torch_flash_f32.split``, hi rounded as ``cvt.rna.tf32``, lo as the
  tensor cores read x - hi): a m16n8k8 step adds a_lo b_hi, a_hi b_lo and
  a_hi b_hi; each k pair (16 rows i, two steps of 8) goes into a partial
  from +0 that is added to its warp's accumulator, the warps that share an
  m tile (``8 / MT`` of them, ``MT`` = 8 x ``CK_KP`` / NP) hold the k pairs
  ip MT .. ip MT + MT - 1 of each ``CK_KP``-row panel and their sums are
  added in warp order; the intra product's k (the chunk's steps s) as the
  kernel orders it (step 0: s = 4q, 4q + 1; step 1: 4q + 2, 4q + 3);
* S = P_C S + v^T (k Q), the chunk's steps one k pair, each step's three
  products into a partial of its own from +0.

It is held within ``chip_smoke.RWKV_LIMIT`` = 2e-4 of max(1, max |plain|)
(what the card holds the kernel to) against the plain version
(``repro_torch.kernels.ref.rwkv6_scan_ref``) at N = 65 to 1100, T not a
multiple of C, with and without s0, decays of 1e-30 (finite), 1.5 (the
bits of 1) and near 1 over many chunks, and bf16 inputs (plus one bf16 ulp),
and against the reference's Pallas kernel in interpret mode; single-pass
TF32 (``a_hi b_hi`` alone) misses the limit, which is why the kernel runs
three products. C, the panel rows, the warps, the largest N with S on chip
and the slab width at each N are read from the source.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_f32 import split, tf32, tf32_rz
from test_torch_gae import reference_pallas_load  # noqa: F401  (fixture)

import chip_smoke
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6_scan
from repro_torch.kernels import ref

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
      / "rwkv6_scan.cu")
LIMIT = 2e-4  # chip_smoke.RWKV_LIMIT


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: on one thread they do not wait for the threads of
    the other pytest workers that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def constants() -> dict:
    text = CU.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
            for name in ("CK_C", "CK_KP", "CK_WARPS", "CK_MAX_NP", "CK_BPARTS", "CK_DPARTS")}


def dispatch() -> list[tuple[int, int]]:
    """(largest N, NP) of each rwkv6_chunked launch in ``launch``, in order;
    the last (None, 0) takes every larger N."""
    body = CU.read_text().split("int launch(const T* r", 1)[1].split("\n}\n", 1)[0]
    out = []
    for bound, np_ in re.findall(r"if \(n <= (\w+)\)\n\s+return launch_chunked<T, (\w+)>",
                                 body):
        cst = constants()
        out.append((cst.get(bound) or int(bound), cst.get(np_) or int(np_)))
    last = re.findall(r"\n  return launch_chunked<T, (\w+)>", body)
    assert last == ["0"]
    return out + [(None, 0)]


def tile(n: int) -> tuple[int, int, int]:
    """(NP, MT, CP) of rwkv6_chunked at head size n (NP = 0: S in memory)."""
    np_ = next(p for bound, p in dispatch() if bound is None or n <= bound)
    cst = constants()
    mt = 1 if np_ == 0 else cst["CK_WARPS"] * cst["CK_KP"] // np_
    return np_, mt, 16 * mt


def step_sets(c: int) -> list[torch.Tensor]:
    """The chunk's steps s of each m16n8k8 step of the intra product and the
    update (k = s): step 0 takes 4q and 4q + 1, step 1 4q + 2 and 4q + 3."""
    return [torch.tensor([4 * q + 2 * st + e for q in range(c // 4) for e in (0, 1)])
            for st in (0, 1)]


def products(a: torch.Tensor, b: torch.Tensor, steps, three: bool) -> torch.Tensor:
    """sum over the k steps of (..., M, K) @ (..., K, N) as the kernel's
    MMAs: each step's a_lo b_hi, a_hi b_lo and a_hi b_hi (or a_hi b_hi
    alone) into the partial, from +0."""
    (ah, al), (bh, bl) = split(a), split(b)
    part = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for ks in steps:
        if three:
            part = part + al[..., ks] @ bh[..., ks, :]
            part = part + ah[..., ks] @ bl[..., ks, :]
        part = part + ah[..., ks] @ bh[..., ks, :]
    return part


def emulate(r, k, v, w, u, s0=None, *, three: bool = True):
    """rwkv6_chunked's (out, S_T) on (B, T, H, N) operands, fp32 or bf16
    (converted to fp32 as the kernel stages them; out rounded once)."""
    cst = constants()
    c_len, kp_rows = cst["CK_C"], cst["CK_KP"]
    b, t, h, n = r.shape
    _, mt, _ = tile(n)
    wp = cst["CK_WARPS"] // mt
    rf, kf, vf, wf = (x.float().permute(0, 2, 1, 3) for x in (r, k, v, w))  # (B, H, T, N)
    uf = u.float()[None, :, :]
    s = (torch.zeros(b, h, n, n) if s0 is None else s0.float().clone())  # S[i][j]
    out = torch.empty(b, h, t, n)
    sets = step_sets(c_len)
    pairs = -(-n // 16)
    for t0 in range(0, t, c_len):
        steps = min(c_len, t - t0)

        def chunk(x, fill):
            y = torch.full((b, h, c_len, n), fill)
            y[:, :, :steps] = x[:, :, t0:t0 + steps]
            return y

        rc, kc, vc = chunk(rf, 0.0), chunk(kf, 0.0), chunk(vf, 0.0)
        wc = chunk(wf, 1.0).clamp(1e-37, 1.0)
        p_run = [torch.ones(b, h, n)]
        for j in range(c_len):
            p_run.append(p_run[-1] * wc[:, :, j])
        q_run = [torch.ones(b, h, n)]
        for j in range(c_len - 1, 0, -1):
            q_run.insert(0, q_run[0] * wc[:, :, j])
        rp = rc * torch.stack(p_run[:c_len], 2)
        kq = kc * torch.stack(q_run, 2)
        decay = p_run[c_len]
        lsum, acc = [], torch.zeros(b, h, n)
        for j in range(c_len):
            acc = acc + torch.log2(wc[:, :, j])
            lsum.append(acc)
        a = torch.zeros(b, h, c_len, c_len)
        for tb in range(c_len // 2):
            t1, t2 = 2 * tb, 2 * tb + 1
            a[:, :, t2, t1] = (rc[:, :, t2] * kc[:, :, t1]).sum(-1)
            for tt in (t1, t2):
                a[:, :, tt, tt] = (rc[:, :, tt] * uf * kc[:, :, tt]).sum(-1)
            for sb in range(tb):
                s1, s2 = 2 * sb, 2 * sb + 1
                e12 = torch.exp2(lsum[t1 - 1] - lsum[s2])
                e22 = e12 * wc[:, :, t1]
                e11, e21 = e12 * wc[:, :, s2], e22 * wc[:, :, s2]
                for (tt, ss), e in (((t1, s1), e11), ((t1, s2), e12), ((t2, s1), e21),
                                    ((t2, s2), e22)):
                    a[:, :, tt, ss] = (rc[:, :, tt] * e * kc[:, :, ss]).sum(-1)
        # state term: out^T[j][t] = sum_i S[i][j] (r P)[t][i], by k pair, in
        # each warp's order, then the warps of an m tile in order
        st_t = s.transpose(-1, -2)            # S^T: (j, i)
        rp_t = rp.transpose(-1, -2)           # (r P)^T: (i, t)
        warp_acc = [torch.zeros(b, h, n, c_len) for _ in range(wp)]
        for kp in range(pairs):
            panel_pair = kp % (kp_rows // 16)
            rows = [torch.arange(16 * kp + 8 * st, min(16 * kp + 8 * st + 8, n))
                    for st in (0, 1) if 16 * kp + 8 * st < n]
            ip = panel_pair // mt
            warp_acc[ip] = warp_acc[ip] + products(st_t, rp_t, rows, three)
        y = warp_acc[0]
        for ip in range(1, wp):
            y = y + warp_acc[ip]
        y = y + products(vc.transpose(-1, -2), a.transpose(-1, -2), sets, three)
        out[:, :, t0:t0 + steps] = y.transpose(-1, -2)[:, :, :steps]
        # update: S^T = S^T diag(P_C) + v^T (k Q), a partial a step
        upd = [products(vc.transpose(-1, -2), kq, [ks], three) for ks in sets]
        s = (st_t * decay[:, :, None, :] + (upd[0] + upd[1])).transpose(-1, -2)
    return out.permute(0, 2, 1, 3).to(r.dtype), s


def inputs(b, t, h, n, *, seed, decay=None, carried=True, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, n)).astype(np.float32) for _ in range(3))
    if decay is None:
        w = np.clip(1 / (1 + np.exp(-3 * rng.normal(size=(b, t, h, n)))), 1e-6, 1 - 1e-6)
    else:
        w = np.full((b, t, h, n), decay)
    u = 0.5 * rng.normal(size=(h, n))
    s0 = rng.normal(size=(b, h, n, n)).astype(np.float32) if carried else None
    arrays = [r, k, v, w.astype(np.float32), u.astype(np.float32)]
    out = [torch.from_numpy(a).to(dtype) for a in arrays]
    return out + [None if s0 is None else torch.from_numpy(s0)]


def errors(got, want) -> tuple[float, float]:
    """chip_smoke's measures: max |out - plain| over max(1, max |plain|),
    and the same of S_T."""
    (o, s), (wo, ws) = got, want
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    e = float((o.float() - wo.float()).abs().max()) / max(1.0, float(wo.float().abs().max()))
    e_s = float((s - ws).abs().max()) / max(1.0, float(ws.abs().max()))
    return e, e_s


# N from one past RWKV-6's head size to past the largest on chip, T ragged
CASES = [(1, 37, 2, 65), (2, 45, 1, 96), (1, 40, 1, 128), (1, 35, 1, 256),
         (1, 21, 2, 300), (1, 19, 1, 512)]


@pytest.mark.parametrize("carried", [True, False])
@pytest.mark.parametrize("b,t,h,n", CASES)
def test_emulation_within_the_limit(b, t, h, n, carried):
    args = inputs(b, t, h, n, seed=n + t, carried=carried)
    got = emulate(*args)
    assert got[0].shape == (b, t, h, n) and got[1].shape == (b, h, n, n)
    e, e_s = errors(got, ref.rwkv6_scan_ref(*args))
    assert e <= LIMIT and e_s <= LIMIT


def test_emulation_past_the_largest_n_on_chip():
    """N = 1100: S in S_T's memory, 16-column slabs, the same arithmetic."""
    assert tile(1100)[0] == 0 and tile(constants()["CK_MAX_NP"])[0] != 0
    args = inputs(1, 17, 1, 1100, seed=3)
    e, e_s = errors(emulate(*args), ref.rwkv6_scan_ref(*args))
    assert e <= LIMIT and e_s <= LIMIT


def test_bf16_inputs_within_the_limit_and_an_ulp():
    args = inputs(1, 33, 2, 128, seed=5, dtype=torch.bfloat16)
    got, want = emulate(*args), ref.rwkv6_scan_ref(*args)
    assert got[0].dtype == torch.bfloat16
    top = max(1.0, float(want[0].float().abs().max()))
    assert float((got[0].float() - want[0].float()).abs().max()) <= (
        LIMIT + chip_smoke.BF16_ULP) * top
    assert errors(got, want)[1] <= LIMIT


def test_tiny_decays_stay_finite():
    """w = 1e-30: every factor underflows to 0 within a step or two, never
    to inf or NaN (2^(L - L') of huge negative L differences is 0)."""
    args = inputs(1, 40, 1, 128, seed=7, decay=1e-30, carried=False)
    got = emulate(*args)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    e, e_s = errors(got, ref.rwkv6_scan_ref(*args))
    assert e <= LIMIT and e_s <= LIMIT


def test_decays_above_one_are_one_bitwise():
    above = inputs(1, 40, 1, 96, seed=9, decay=1.5)
    at_one = above[:3] + [torch.ones_like(above[3])] + above[4:]
    for x, y in zip(emulate(*above), emulate(*at_one)):
        assert torch.equal(x, y)


def test_decays_near_one_over_many_chunks():
    """w = 1 - 1e-4 over 12 chunks: the state grows to ~T k v and the
    products of 16 decays stay near 1, within the limit of the plain walk."""
    args = inputs(1, 190, 1, 128, seed=11, decay=1 - 1e-4)
    e, e_s = errors(emulate(*args), ref.rwkv6_scan_ref(*args))
    assert e <= LIMIT and e_s <= LIMIT


@pytest.mark.parametrize("b,t,h,n", [(1, 45, 1, 128), (1, 33, 1, 256)])
def test_single_pass_tf32_misses_the_limit(b, t, h, n):
    args = inputs(b, t, h, n, seed=13 + n)
    want = ref.rwkv6_scan_ref(*args)
    three = max(errors(emulate(*args), want))
    single = max(errors(emulate(*args, three=False), want))
    assert three <= LIMIT < single
    assert single > 10 * three


# the reference's Pallas kernel in interpret mode (its own chunk of 16),
# with s0, at a ragged N and at a whole panel
PALLAS_CASES = [(1, 40, 2, 65), (1, 32, 1, 128)]


@pytest.mark.parametrize("b,t,h,n", PALLAS_CASES)
def test_emulation_matches_pallas(reference_pallas_load, b, t, h, n):  # noqa: F811
    args = inputs(b, t, h, n, seed=17 + n)
    want_out, want_s = pallas_rwkv6_scan(*(jnp.asarray(a.numpy()) for a in args),
                                         chunk=16, interpret=True)
    got_out, got_s = emulate(*args)
    for g, w_ in ((got_out, want_out), (got_s, want_s)):
        w_ = torch.from_numpy(np.array(w_))
        assert float((g - w_).abs().max()) <= LIMIT * max(1.0, float(w_.abs().max()))


def test_split_is_the_kernels():
    """split_tf32's hi is cvt.rna.tf32 (``tf32``), its lo the exact x - hi
    read to 19 bits by the tensor cores (``tf32_rz``), as ``split``."""
    body = re.search(r"void split_tf32\(.*?\n}\n", CU.read_text(), re.S).group(0)
    assert "hi = (__float_as_uint(x) + 0x1000u) & ~0x1fffu;" in body
    assert "lo = __float_as_uint(x - __uint_as_float(hi));" in body
    v = torch.tensor([1.0 + 2.0 ** -11, -3.14159265, 7e-5], dtype=torch.float32)
    hi, lo = split(v)
    assert torch.equal(hi, tf32(v)) and torch.equal(lo, tf32_rz(v - hi))


def test_emulated_tiles_are_the_kernels():
    """The emulation's chunk is the kernel's CK_C and chip_smoke's
    RWKV_CHUNK; A's 2 x 2 blocks and their row parts fill the CTA; the
    slab holds the state on chip to CK_MAX_NP >= 1024 (64 floats a lane of
    8 warps), and every N past 64 routes to rwkv6_chunked."""
    cst = constants()
    assert cst["CK_C"] == chip_smoke.RWKV_CHUNK == 16 and cst["CK_KP"] % 16 == 0
    blocks = (cst["CK_C"] // 2) * (cst["CK_C"] // 2 - 1) // 2
    assert blocks * cst["CK_BPARTS"] + cst["CK_C"] // 2 * cst["CK_DPARTS"] == 32 * cst["CK_WARPS"]
    assert cst["CK_MAX_NP"] >= 1024
    for n in (65, 100, 128, 129, 256, 300, 512, 700, 1024):
        np_, mt, cp = tile(n)
        assert np_ >= n and np_ % cst["CK_KP"] == 0 and cst["CK_WARPS"] % mt == 0
        assert cp * np_ // (32 * cst["CK_WARPS"]) == 64  # S floats a lane
    assert tile(1025) == (0, 1, 16)
    assert "if (n <= 64)\n    return launch_np<T, 64>" in CU.read_text()
