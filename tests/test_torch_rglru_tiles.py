"""The tile walk of the ``rglru_scan`` kernel (``kernels/csrc/rglru_scan.cu``),
modelled on the CPU, and the chain's order of operations emulated in torch.

The kernel runs only on the card; what can be held here is its schedule and
its arithmetic. The model reads the ring's constants (``GROUP``, ``T_TILE``,
``STAGES``, ``THREADS``) from the source as text and repeats, for each CTA
of a shape, what the source does: the prologue's fills, and a tile at a
time the producer warp's wait, the barrier, the refill of the slot
``STAGES - 1`` tiles ahead and the chain warp's walk of the tile, with
each producer lane's share of a fill (``fill``) and each chain lane's
share of the staged h rows (16-byte path) as the source indexes them. It
checks that every (b, t, w) of a and of b is copied into the ring exactly
once and every h written exactly once, in ascending t per channel; that
the chain only reads a tile whose copy group has completed; and that no
slot is refilled before the chain is done with the tile it holds. The
launcher's choice of copy width (``copy_width``) is mirrored here and held
to cover every W and dtype of ``chip_smoke.RGLRU_SWEEP`` with copies that
keep their alignment.

The emulation walks the chain tile by tile as the kernel does (a clamped by
``fminf(fmaxf(...))``, the product and the sum rounded separately, an fp32
carry, bf16 h rounded once from it) and is held bitwise to the plain
version, ``repro_torch.kernels.ref.rglru_scan_ref``, which
``test_torch_ops.py`` holds to the reference's Pallas kernel in interpret
mode; the card holds the kernel bitwise to the same plain version.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "rglru_scan.cu"
VEC16, ELEM = 0, 1
SIZES = {"float32": 4, "bfloat16": 2}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
SHAPES = CS.RGLRU_SWEEP + [CS.RGLRU_UNALIGNED, CS.RGLRU_PATH, CS.LM_RGLRU,
                           (CS.LM_CHECK_BATCH, CS.LM_CHECK_PROMPT, 2560)]


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr (?:int|long long) {name} = (\d+);", CU.read_text())
    assert len(found) == 1, f"rglru_scan.cu defines {name} {len(found)} times"
    return int(found[0])


GROUP, T_TILE = _constant("GROUP"), _constant("T_TILE")
STAGES, THREADS = _constant("STAGES"), _constant("THREADS")


def copy_width(size: int, w: int, pointers) -> int:
    """``copy_width`` of the source: the widest copy the rows of w elements
    of ``size`` bytes and the base pointers of a, b and h allow."""
    p = 0
    for x in pointers:
        p |= x
    row = w * size
    if row % 16 == 0 and p % 16 == 0:
        return VEC16
    return ELEM


def copy_elems(size: int, copy: int) -> int:
    return {VEC16: 16 // size, ELEM: 1}[copy]


def fill_copies(size: int, copy: int, rows: int, cols: int):
    """The copies of one ``fill``, over the producer warp's 32 lanes:
    (lane, array, row, first column) of each copy, and E."""
    e_ = copy_elems(size, copy)
    cpr = GROUP // e_
    rpp = 32 // cpr
    assert rpp * cpr == 32 and T_TILE % rpp == 0
    out = []
    for ct in range(32):
        r0, c = ct // cpr, (ct % cpr) * e_
        if c >= cols:
            continue
        for p in range(T_TILE // rpp):
            if p * rpp < rows - r0:
                out += [(ct, arr, r0 + p * rpp, c) for arr in (0, 1)]
    ct, arr, r, c = (np.array(x, np.int64) for x in zip(*out)) if out else [np.zeros(0, np.int64)] * 4
    return ct, arr, r, c, e_


def staged_stores(size: int, steps: int, cols: int):
    """The 16-byte h stores of one tile on the 16-byte path: (chain lane,
    row, first column) of each store."""
    e_ = 16 // size
    cpr = GROUP // e_
    rpp = 32 // cpr
    out = []
    for lane in range(32):
        r0, c = lane // cpr, (lane % cpr) * e_
        if c >= cols:
            continue
        for p in range(T_TILE // rpp):
            if r0 + p * rpp < steps:
                out.append((lane, r0 + p * rpp, c))
    tid, r, c = (np.array(x, np.int64) for x in zip(*out)) if out else [np.zeros(0, np.int64)] * 3
    return tid, r, c, e_


def walk(t_len: int, cols: int, size: int, copy: int, stages: int = STAGES, ahead=None):
    """One CTA's walk of T over a group of ``cols`` channels with a ring of
    ``stages`` slots (the source's ``STAGES``), as the source orders it;
    ``ahead`` (the source: ``stages - 1``) is how many tiles past the walked
    one a refill lands.
    Returns (copies into the ring of a and b, (2, t_len, GROUP) counts; h
    writes, (t_len, GROUP) counts; the order in which each channel's h rows
    were written)."""
    ahead = stages - 1 if ahead is None else ahead
    tiles = -(-t_len // T_TILE)
    slot_tile = [None] * stages      # the tile each ring slot holds
    done_with = set()                # tiles the chain has walked
    groups: list[int | None] = []    # the tile each committed copy group holds
    copied = np.zeros((2, t_len, GROUP), np.int64)
    written = np.zeros((t_len, GROUP), np.int64)
    order: list[list[int]] = [[] for _ in range(GROUP)]

    def fill(k):
        slot = k % stages
        held = slot_tile[slot]
        assert held is None or held in done_with, (
            f"slot {slot} refilled with tile {k} before the chain walked tile {held}")
        slot_tile[slot] = k
        t0 = k * T_TILE
        _, arr, r, c, e_ = fill_copies(size, copy, min(T_TILE, t_len - t0), cols)
        for x in range(e_):
            np.add.at(copied, (arr, t0 + r, c + x), 1)

    for k in range(stages - 1):  # the prologue
        groups.append(k if k < tiles else None)
        if k < tiles:
            fill(k)
    for k in range(tiles):
        # cp.async.wait_group STAGES - 2: all but the newest STAGES - 2
        # groups have completed; the barrier publishes them
        complete = {g for g in groups[:len(groups) - (stages - 2)] if g is not None}
        assert k in complete, f"tile {k} read before its copy group completed"
        n = k + ahead
        groups.append(n if n < tiles else None)
        if n < tiles:
            fill(n)
        assert slot_tile[k % stages] == k, f"tile {k} is not in its slot"
        t0 = k * T_TILE
        steps = min(T_TILE, t_len - t0)
        if copy == VEC16:
            _, r, c, e_ = staged_stores(size, steps, cols)
            for x in range(e_):
                np.add.at(written, (t0 + r, c + x), 1)
            for ch in range(cols):
                order[ch].extend(t0 + np.sort(r[(c <= ch) & (ch < c + e_)]))
        else:
            for j in range(steps):
                written[t0 + j, :cols] += 1
                for ch in range(cols):
                    order[ch].append(t0 + j)
        done_with.add(k)
    return copied, written, order


def _pointer_cases(size: int):
    """Base pointers of a, b and h: the allocator's (512-byte aligned), and
    a and b one element into their buffers (RGLRU_UNALIGNED)."""
    return [(512, 1024, 4096), (512 + size, 1024 + size, 4096)]


def _check_walk(t, w, size, copy):
    groups = -(-w // GROUP)
    for cols in {min(GROUP, w - g * GROUP) for g in range(groups)}:
        copied, written, order = walk(t, cols, size, copy)
        assert (copied[:, :, :cols] == 1).all() and (copied[:, :, cols:] == 0).all()
        assert (written[:, :cols] == 1).all() and (written[:, cols:] == 0).all()
        for ch in range(cols):
            assert order[ch] == list(range(t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_every_element_is_copied_and_written_once_in_order(shape, dtype):
    """At the copy widths the launcher picks for the shape."""
    b, t, w = shape
    size = SIZES[dtype]
    groups = -(-w // GROUP)
    # the grid (ceil(W / GROUP), B) covers every channel of every row once
    seen = np.zeros(w, np.int64)
    for g in range(groups):
        seen[g * GROUP: g * GROUP + min(GROUP, w - g * GROUP)] += 1
    assert (seen == 1).all()
    for pointers in _pointer_cases(size):
        copy = copy_width(size, w, pointers)
        e_ = copy_elems(size, copy)
        # every copy keeps its width's alignment at every batch row and step
        step = np.arange(min(t, 3 * T_TILE + 1))
        for bi in (0, b - 1):
            for g in range(groups):
                _, _, _, c, _ = fill_copies(size, copy, T_TILE, min(GROUP, w - g * GROUP))
                elem = (bi * t + step[:, None]) * w + g * GROUP + c[None, :]
                assert ((pointers[0] + elem * size) % (e_ * size) == 0).all()
        _check_walk(t, w, size, copy)


RAGGED_T = [1, T_TILE - 1, T_TILE + 1, 5 * T_TILE + 3]


@pytest.mark.parametrize("t", RAGGED_T)
@pytest.mark.parametrize("copy", [VEC16, ELEM], ids=["vec16", "elem"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_instantiation_walks_ragged_shapes(dtype, copy, t):
    """Each (dtype, copy width) the source instantiates, at T of one step,
    under a tile, one past a tile and several tiles, and a ragged W."""
    _check_walk(t, 2 * GROUP + 8, SIZES[dtype], copy)


def test_the_model_has_the_sources_warps():
    """The model's roles are the source's: a chain warp of GROUP lanes,
    then one producer warp that issues every copy."""
    text = CU.read_text()
    assert GROUP == 32 and THREADS == 64
    assert "const bool chain = threadIdx.x < 32, copier = !chain;" in text
    assert "constexpr bool STAGED = COPY == VEC16;" in text


def test_the_walk_catches_a_slot_refilled_too_early():
    """Refilling one tile further ahead than the source does overwrites the
    slot of the tile the chain is about to walk: the model's check fires,
    so it is not vacuous."""
    walk(5 * T_TILE, GROUP, 4, VEC16)
    with pytest.raises(AssertionError, match="refilled"):
        walk(5 * T_TILE, GROUP, 4, VEC16, ahead=STAGES)


def test_the_sweep_holds_the_rings_edges():
    ts = {t for _, t, _ in CS.RGLRU_SWEEP}
    ws = {w for _, _, w in CS.RGLRU_SWEEP}
    assert 1 in ts
    assert any(1 < t < T_TILE for t in ts)
    assert T_TILE + 1 in ts
    assert any(w % 2 for w in ws)           # bf16's element copies
    assert any(w < GROUP for w in ws)
    assert any(w % GROUP for w in ws if w > GROUP)
    assert (CS.LM_CHECK_BATCH, CS.LM_CHECK_PROMPT, 2560) in CS.RGLRU_SWEEP


def test_the_sweep_takes_every_copy_width():
    """At the allocator's alignment both dtypes take the 16-byte copies and,
    at a W whose row is not a multiple of 16 bytes, the element copies;
    the unaligned case takes the element copies in both dtypes."""
    taken = {dtype: {copy_width(size, w, (512, 1024, 4096)) for _, _, w in CS.RGLRU_SWEEP}
             for dtype, size in SIZES.items()}
    assert taken == {"float32": {VEC16, ELEM}, "bfloat16": {VEC16, ELEM}}
    _, _, w = CS.RGLRU_UNALIGNED
    for size in SIZES.values():
        assert copy_width(size, w, (512, 1024, 4096)) == VEC16
        assert copy_width(size, w, _pointer_cases(size)[1]) == ELEM


def test_copy_width_mirrors_the_source():
    body = re.search(r"int copy_width\(.*?\n}\n", CU.read_text(), re.S).group(0)
    assert "reinterpret_cast<uintptr_t>(h)" in body
    assert re.findall(r"if \((.*?)\) return (\w+);", body) == [
        ("row % 16 == 0 && p % 16 == 0", "VEC16")]
    assert body.rstrip().endswith("return ELEM;\n}")


def emulate(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None):
    """The kernel's chain on the CPU, a tile of T_TILE steps at a time: a
    and b widened to fp32 as the chain reads them from the ring, a clamped
    by fminf(fmaxf(a, 1e-37), 1), the product and the sum rounded each on
    its own, h stored in a's dtype from the fp32 carry."""
    bb, t, w = a.shape
    hc = torch.zeros(bb, w) if h0 is None else h0.clone()
    h = torch.empty_like(a)
    lo, hi = torch.tensor(1e-37, dtype=torch.float32), torch.tensor(1.0)
    for t0 in range(0, t, T_TILE):
        av = a[:, t0:t0 + T_TILE].float()
        bv = b[:, t0:t0 + T_TILE].float()
        for j in range(av.shape[1]):
            at = torch.minimum(torch.maximum(av[:, j], lo), hi)
            hc = torch.add(torch.mul(at, hc), bv[:, j])
            h[:, t0 + j] = hc.to(a.dtype)
    return h, hc


EMULATED = [s for s in CS.RGLRU_SWEEP + [CS.RGLRU_UNALIGNED] if s[0] * s[1] * s[2] <= 2 ** 20]


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no_h0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", EMULATED, ids=[str(s) for s in EMULATED])
def test_chain_emulation_is_the_plain_version_bitwise(shape, dtype, with_h0):
    b, t, w = shape
    rng = np.random.default_rng(t * 1000 + w)
    a = torch.from_numpy(1 / (1 + np.exp(-(2.0 + rng.normal(size=(b, t, w)))))).float()
    a[..., :3] = torch.tensor([1e-25, 1.5, 1.0])  # below the clamp, above it, at it
    bv = torch.from_numpy(rng.normal(size=(b, t, w))).float()
    h0 = torch.from_numpy(rng.normal(size=(b, w))).float() if with_h0 else None
    a, bv = a.to(dtype), bv.to(dtype)
    got, got_last = emulate(a, bv, h0)
    want, want_last = ref.rglru_scan_ref(a, bv, h0)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want) and torch.equal(got_last, want_last)


def test_a_fused_multiply_add_would_move_bits():
    """Why the kernel rounds the product and the sum each on its own: one
    rounding of a h + b (an FMA, computed here in fp64 and rounded once)
    gives other bits than the plain version at an LM-like shape."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(1 / (1 + np.exp(-(2.0 + rng.normal(size=(2, 256, 64)))))).float()
    bv = torch.from_numpy(rng.normal(size=(2, 256, 64))).float()
    hc = torch.zeros(2, 64)
    fused = torch.empty_like(a)
    for j in range(a.shape[1]):
        hc = (a[:, j].double() * hc.double() + bv[:, j].double()).float()
        fused[:, j] = hc
    want, _ = ref.rglru_scan_ref(a, bv)
    assert not torch.equal(fused, want)
