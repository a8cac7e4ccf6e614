#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the checkout root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. ``env``    card name and power limit, torch / CUDA / nvcc versions;
2. ``build``  compiles every CUDA source of the checkout (one ``nvcc`` each,
   all started together) into a fresh directory of this run, so a re-run
   builds again and never reuses an earlier run's libraries; reports each
   kernel's registers and spill (``ptxas -v``) and the instructions, FFMAs
   and tensor-core MMAs of its innermost FFMA or MMA loop (``cuobjdump
   -sass``);
3. ``kernels``  each kernel against its plain PyTorch version on the card at
   the main paths' shapes (GBATC: S=58, NB=20480, D=80; flash attention:
   (4096, 2, 232, 16) fp32 non-causal; the replay also at partial_path's
   selective shapes) and at ragged and reference shapes,
   with its time, the plain version's, the one-call library yardstick's
   and the card's bound for the same work; the fp64 projection and flash
   attention also give the same bits twice and the same bits for a
   sub-range of their rows (species, blocks or batch) as the full call,
   and so do the fp32 select and correct modes, where select on (c, rank,
   m) must also be bitwise correct on where(rank < m, c, 0), at the main
   shape and every ragged one;
4. ``main_path``  ``GBATCCodec.compress`` (fit + guarantee + container) and
   ``codec.decompress`` from the bytes alone, conv family, at the paper's
   widths on an S3D surrogate of 58 x 16 x 320 x 320, with the kernels'
   launch counts reset just before and read just after compress,
   decompress and a second-bound compress (one select a compress, one
   replay a decompress); the line carries the sha256 of the
   reconstruction and of the blob, so two trees can be held to the same
   bits; then, on the path's own prepared state, the engine's device
   select backend against its host backend at both bounds: the artifacts
   (coeff_q, CSR index, basis) and the reconstruction must be equal byte
   for byte, and the line reports the blocks whose cut m_eff differs;
5. ``attention_path``  the same for the attention family (arch (32, 2, 1,
   64)) on the same data;
6. ``ops_path``  each of the six ``repro_torch.kernels.ops.*_op`` functions
   (the JAX package's ``kernels/ops.py``, name for name) once at its
   full-width shape, from numpy inputs on the default device, against its
   plain version, with the launch counts reset just before each call and
   read just after (each call launches its own kernel once and nothing
   else); the ``kernels`` phase also holds the five kernels behind them
   that no other path runs (2D GBATC pair, block_quant, rglru_scan,
   rwkv6_scan) against their plain versions at those shapes, at the
   reference's sweeps and in bf16, and each for the same bits twice; the
   fp32 2D projection also for rows 100-5003 and the field's last rows,
   and rwkv6_scan for batch 0-1, as in the full call;
7. ``partial_path``  on the blobs, artifact and decoded fields of the two
   codec paths (no new fit): selective decodes of the conv blob
   (``decompress(blob, species=..., time_range=...)``) bitwise against the
   slice of its full decode, cold and warm, with their bytes parsed and
   exactly one replay launch each; the conv artifact written at container
   v1-v4 and read back bitwise, v1 in full, the staged
   ``decompress_reference`` bitwise the fused decode; ``verify_blob`` over
   a few hundred seeded bit flips (all must be detected), one corrupt
   species and one corrupt latent shard raised in raise mode and
   quarantined by salvage (bitwise elsewhere); one selective decode of the
   attention blob through flash attention;
8. the ``{"kernels": [...]}`` line, the card line, and the final ``ok`` line.

Without CUDA the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense, full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}  # fp64: tensor-core DMMA rate

S, NB, D = 58, 20480, 80  # main-path kernel shapes (T=16, 320x320, block 4x5x4)
RAGGED = [(3, 513, 80), (5, 513, 64), (2, 1, 80), (4, 100, 37), (2, 77, 128),
          (3, 45, 97)]
FP32_LIMIT = 1e-5  # max abs difference, unit-scale inputs, fp32 accumulate order
FP64_REL_LIMIT = 1e-12  # max abs difference relative to the row's l2 norm
# row ranges of the fp64 projection's sub-range checks: each starts inside
# a 64-row tile, so its rows meet other tile and fragment positions
PROJECT_SUBRANGES = [(100, 5003), (20417, 20480), (1, 2)]
# the replay's shapes on partial_path's selective decodes: (species
# selected, the window's block rows at 5120 a block group)
PARTIAL_CORRECT_SHAPES = [(3, 10240), (1, 20480), (58, 5120), (1, 5120)]

# flash attention: the attention family's shape per fused-decode chunk
# (4096 blocks, 2 heads, 58 species x 4 frames = 232 tokens, head dim 16)
# and the reference's own sweep (tests/test_kernels.py) plus ragged shapes:
# (b, h, tq, tk, d, causal, window, dtypes)
FLASH_PATH = (4096, 2, 232, 16)
FLASH_SHAPES = [
    (1, 1, 128, 128, 64, True, 0, ("float32", "bfloat16")),
    (2, 3, 256, 256, 64, True, 0, ("float32", "bfloat16")),
    (1, 2, 128, 384, 128, True, 0, ("float32", "bfloat16")),
    (1, 1, 200, 200, 64, True, 0, ("float32", "bfloat16")),
    (2, 2, 64, 64, 32, True, 0, ("float32", "bfloat16")),
    (1, 2, 256, 256, 64, True, 16, ("float32",)),
    (1, 2, 256, 256, 64, True, 64, ("float32",)),
    (1, 2, 256, 256, 64, True, 1000, ("float32",)),
    (1, 1, 128, 256, 64, False, 0, ("float32",)),
    (2, 2, 232, 232, 16, False, 0, ("float32", "bfloat16")),
    (3, 2, 1, 16, 16, False, 0, ("float32", "bfloat16")),
    (1, 2, 100, 37, 8, False, 0, ("float32",)),
    (2, 1, 70, 300, 128, False, 24, ("float32",)),
]
# the reference's tolerances (tests/test_kernels.py::_tol), max abs diff
FLASH_LIMIT = {"float32": 2e-5, "bfloat16": 2e-2}

# the kernels behind kernels/ops.py that no codec path runs, at full-width
# shapes of configurations the repo supports:
GBATC_2D = (S * NB, D)  # the main path's 58 x 20480 blocks under one basis
BQ_PATH = ((14336, 4096), 8, 64)  # a gradient bucket the size of RWKV-6 7B's
# channel-mix weight (configs/rwkv6_7b.py) at CompressionConfig's defaults
# (parallel/gradient_compression.py:39-41): (shape, n_bits, block)
RGLRU_PATH = (8, 4096, 2560)  # RecurrentGemma-2B's rglru_width
RWKV_PATH = (8, 1024, 64, 64)  # RWKV-6 7B: 64 heads of 64
# and at the reference's own sweeps (tests/test_kernels.py) plus ragged ones
GBATC_2D_SWEEP = [(100, 80), (1000, 80), (64, 64), (513, 80), (77, 37)]
BQ_SWEEP = [((64, 256), 64), ((3, 7, 128), 32), ((1024, 64), 64), ((5, 600), 300)]
RGLRU_SWEEP = [(1, 64, 32), (2, 128, 256), (1, 100, 130)]
RWKV_SWEEP = [(1, 32, 1, 16), (2, 64, 2, 32), (1, 100, 2, 64), (1, 128, 4, 64),
              (2, 37, 3, 20)]
# rows of the fp32 2D projection's sub-range checks at GBATC_2D: a range
# that starts inside a 64-row tile and ends in a ragged one, and the last
# rows of the field as one ragged tile
PROJECT_2D_SUBRANGES = [(100, 5003), (GBATC_2D[0] - 37, GBATC_2D[0])]
RGLRU_LIMIT = 1e-5  # max abs diff at unit-scale inputs
RWKV_LIMIT = 2e-4   # max abs diff relative to max(1, max |plain|)
BF16_ULP = 2.0 ** -7  # one bf16 rounding of the output, relative


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_env(torch) -> dict:
    from repro_torch.kernels import _build

    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-1]
    info = {
        "phase": "env", "gpu": gpu_line(), "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": ver,
        "cudnn": torch.backends.cudnn.version(),
    }
    emit(info)
    return info


# ptxas -v names each kernel instantiation by its mangled name; a source
# may hold several kernels, one pattern each
PTXAS_NAMES = {
    "gbatc_kernels": [(
        r"gbatc_tile_kernelI([fd])Li(\d)ELi(\d)E",
        lambda m: "{}/{}/cmax{}".format(
            {"f": "f32", "d": "f64"}[m.group(1)],
            ("project", "correct", "select", "masked")[int(m.group(2))],
            m.group(3))), (
        r"project_f64_dmmaILi(\d+)ELi(\d+)ELi(\d+)E",
        lambda m: "f64/project/dmma/nfw{}/tm{}/stages{}".format(*m.groups())), (
        r"project_f32_3xtf32ILi(\d+)ELi(\d+)ELi(\d+)E",
        lambda m: "f32/project/3xtf32/nfw{}/tm{}/stages{}".format(*m.groups())), (
        r"correct_f32_ringILi(\d)ELi(\d+)ELi(\d+)E",
        lambda m: "f32/{}/ring/nch{}/minb{}".format(
            ("project", "correct", "select", "masked")[int(m.group(1))],
            *m.groups()[1:]))],
    "flash_attention": [(
        r"flash_kernelI(f|13__nv_bfloat16)Li(\d+)E",
        lambda m: "flash/{}/dp{}".format(
            "f32" if m.group(1) == "f" else "bf16", m.group(2)))],
    "block_quant": [(
        r"block_quant_kernelI(f|13__nv_bfloat16)Li(\d+)E",
        lambda m: "block_quant/{}/v{}".format(
            "f32" if m.group(1) == "f" else "bf16", m.group(2)))],
    "rglru_scan": [(
        r"rglru_kernelI(f|13__nv_bfloat16)E",
        lambda m: "rglru/{}".format("f32" if m.group(1) == "f" else "bf16"))],
    "rwkv6_scan": [(
        r"rwkv6_kernelI(f|13__nv_bfloat16)Li(\d+)E",
        lambda m: "rwkv6/{}/np{}".format(
            "f32" if m.group(1) == "f" else "bf16", m.group(2)))],
}


def sass_loops(build) -> dict:
    """For each kernel instantiation of PTXAS_NAMES, the instructions, FFMAs
    and tensor-core MMAs (HMMA, DMMA) of the innermost loop that holds the
    most of those two (``cuobjdump -sass`` of the built library); empty
    where cuobjdump is missing."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    loops = {}
    for stem, names in PTXAS_NAMES.items():
        lib = build.build_dir() / f"lib{stem}.so"
        if not (os.path.isfile(tool) and lib.is_file()):
            continue
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120).stdout
        for func in re.split(r"\n\s+Function : ", sass)[1:]:
            hit = next(((m, label) for pattern, label in names
                        if (m := re.search(pattern, func.split("\n", 1)[0]))), None)
            if not hit:
                continue
            ins = [(int(a, 16), op) for a, op in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)]
            spans = [(int(t, 16), int(a, 16)) for a, t in re.findall(
                r"/\*([0-9a-f]{4,})\*/[^;\n]*\bBRA\b[^;\n]*0x([0-9a-f]+)", func)
                if int(t, 16) < int(a, 16)]  # backward branches: loops
            best = None
            for lo, hi in spans:
                if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans):
                    continue  # not innermost
                body = [o for a, o in ins if lo <= a <= hi]
                ffma = sum(o.startswith("FFMA") for o in body)
                mma = sum(o.startswith(("HMMA", "DMMA")) for o in body)
                if ffma + mma and (best is None or ffma + mma > best[1] + best[2]):
                    best = (len(body), ffma, mma)
            if best:
                loops[hit[1](hit[0])] = {"loop_instructions": best[0],
                                         "ffma": best[1], "mma": best[2]}
    return loops


def phase_build() -> dict:
    from repro_torch.kernels import _build

    _build.load()
    info = {"phase": "build", **_build.build_info()}
    # registers and spill bytes per kernel instantiation, from ptxas -v
    usage = {}
    for stem, names in PTXAS_NAMES.items():
        name = None
        for ln in _build.build_log(stem).splitlines():
            hit = next(((m, label) for pattern, label in names
                        if (m := re.search(pattern, ln))), None)
            if hit:
                name = hit[1](hit[0])
            elif name and "spill" in ln:
                usage[name] = {"spill_bytes": sum(
                    int(n) for n in re.findall(r"(\d+) bytes spill", ln))}
            elif name and "registers" in ln:
                usage[name]["registers"] = int(
                    re.search(r"Used (\d+) registers", ln).group(1))
                name = None
    info["ptxas"] = usage
    info["sass_loops"] = sass_loops(_build)
    emit(info)
    if sorted(info["compiled"]) != sorted(_build.SOURCES):
        fail(f"only {info['compiled']} of {list(_build.SOURCES)} were compiled "
             "from the checkout's sources in this run")
    return info


def time_ms(torch, fn, launches: int, warmup: int = 3) -> float:
    """Median over ``launches`` single-launch CUDA-event timings. Operands
    are far larger than the 50 MB L2, so every launch finds it cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(launches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def make_inputs(torch, s, nb, d, dtype, seed):
    """Unit-scale operands with an orthonormal basis per species and a
    rank/cut pair shaped like the engine's (a permutation per row)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(s, nb, d, generator=g, device="cuda", dtype=dtype)
    c = torch.randn(s, nb, d, generator=g, device="cuda", dtype=dtype)
    q, _ = torch.linalg.qr(torch.randn(s, d, d, generator=g, device="cuda",
                                       dtype=torch.float64))
    u = q.to(dtype).contiguous()
    rank = torch.argsort(torch.rand(s, nb, d, generator=g, device="cuda"),
                         dim=-1).to(torch.int32)
    m = torch.randint(0, d + 1, (s, nb), generator=g, device="cuda",
                      dtype=torch.int32)
    return x, c, u, rank, m


def compare(torch, got, want, rows, dtype) -> float:
    """Max abs difference (fp32) or max abs difference over the row's l2
    norm (fp64); fails the run over the stated limit."""
    diff = (got - want).abs()
    if not torch.isfinite(got).all():
        fail("kernel output is not finite")
    if dtype == torch.float64:
        norm = rows.norm(dim=-1, keepdim=True).clamp_min(1e-300)
        err = float((diff / norm).max()) if diff.numel() else 0.0
        if err > FP64_REL_LIMIT:
            fail(f"fp64 kernel differs from plain version: {err:.3e} of row norm")
    else:
        err = float(diff.max()) if diff.numel() else 0.0
        if err > FP32_LIMIT:
            fail(f"fp32 kernel differs from plain version: {err:.3e}")
    return float(diff.max()) if diff.numel() else 0.0


def kernel_row(torch, name, source, replaces, fn, plain, lib, dtype, shape,
               nbytes, flops, launches, err, plain_launches=None, **extra):
    """One ``{"kernels": ...}`` entry: the kernel's time, its plain
    version's, the one-call library yardstick's (``lib``, or None where no
    single call computes the function), and the card's bound for the work.
    ``plain_launches`` times a slow plain version over fewer launches."""
    ms = time_ms(torch, fn, launches)
    plain_ms = (time_ms(torch, plain, plain_launches, warmup=1) if plain_launches
                else time_ms(torch, plain, launches))
    library_ms = time_ms(torch, lib, launches) if lib is not None else None
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}", "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "dtype": dtype, "shape": list(shape),
        "bytes": nbytes, "flops": flops, **extra,
    }


def same_twice(torch, name: str, fn) -> None:
    """Two launches on the same inputs give the same bits."""
    first, second = fn(), fn()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f"{name} is not deterministic: two launches differ")


def same_rows(torch, name: str, full, parts) -> None:
    """A call on a sub-range of the rows gives those rows of the full call,
    bitwise: ``parts`` holds (index into ``full``, the sub-range call's
    result) pairs."""
    for index, got in parts:
        if not torch.equal(got, full[index]):
            fail(f"{name}: a call on rows {index} differs from those rows of "
                 f"the full call (max abs "
                 f"{float((got - full[index]).abs().max()):.3e})")


def fp32_pair_bits(torch, gk, x, c, u, rank, m) -> None:
    """The fp32 select and correct modes keep one order of arithmetic, and
    a row's bits do not depend on where the persistent grid computes it:
    select on (c, rank, m) is bitwise correct on where(rank < m, c, 0);
    both give the same bits twice, and for row sub-ranges
    (PROJECT_SUBRANGES, clipped to NB) and species 1-2 as the full call."""
    s, nb, _ = x.shape
    kept = torch.where(rank < m[..., None], c,
                       torch.zeros((), dtype=c.dtype, device=c.device))
    sel = gk.gbatc_select_accumulate(x, c, rank, m, u)
    cor = gk.gbatc_correct_batched(x, kept, u)
    if not torch.equal(sel, cor):
        fail(f"fp32 select differs from correct on the masked coefficients at "
             f"{tuple(x.shape)} (max abs {float((sel - cor).abs().max()):.3e})")
    same_twice(torch, "gbatc_select_accumulate (fp32)",
               lambda: gk.gbatc_select_accumulate(x, c, rank, m, u))
    same_twice(torch, "gbatc_correct_batched (fp32)",
               lambda: gk.gbatc_correct_batched(x, kept, u))
    ranges = [(a, min(b, nb)) for a, b in PROJECT_SUBRANGES if a < nb] or [(0, nb)]
    sp = slice(1, min(3, s))

    def part(index, *ts):
        return [t[index].contiguous() for t in ts]

    same_rows(torch, "gbatc_select_accumulate (fp32)", sel,
              [((slice(None), slice(a, b)), gk.gbatc_select_accumulate(
                  *part((slice(None), slice(a, b)), x, c, rank, m), u))
               for a, b in ranges]
              + [((sp,), gk.gbatc_select_accumulate(*part(sp, x, c, rank, m, u)))])
    same_rows(torch, "gbatc_correct_batched (fp32)", cor,
              [((slice(None), slice(a, b)), gk.gbatc_correct_batched(
                  *part((slice(None), slice(a, b)), x, kept), u))
               for a, b in ranges]
              + [((sp,), gk.gbatc_correct_batched(*part(sp, x, kept, u)))])


def phase_kernels(torch, launches: int) -> list[dict]:
    from repro_torch.kernels import gbatc_project as gk
    from repro_torch.kernels import ref as kref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- ragged / odd shapes, both dtypes, every kernel -------------------
    ragged_err: dict = {}

    def note(name, dtype, e):
        ragged_err[name, dtype] = max(ragged_err.get((name, dtype), 0.0), e)

    for i, (s, nb, d) in enumerate(RAGGED):
        for dtype in (torch.float32, torch.float64):
            x, c, u, rank, m = make_inputs(torch, s, nb, d, dtype, 100 + i)
            note("gbatc_project_batched", dtype, compare(
                torch, gk.gbatc_project_batched(x, u),
                kref.gbatc_project_batched_ref(x, u), x, dtype))
            note("gbatc_correct_batched", dtype, compare(
                torch, gk.gbatc_correct_batched(x, c, u),
                kref.gbatc_correct_batched_ref(x, c, u), c, dtype))
            note("gbatc_select_accumulate", dtype, compare(
                torch, gk.gbatc_select_accumulate(x, c, rank, m, u),
                kref.gbatc_select_accumulate_ref(x, c, rank, m, u), c, dtype))
            if dtype == torch.float32:
                fp32_pair_bits(torch, gk, x, c, u, rank, m)
    torch.cuda.synchronize()

    # -- main-path shapes: fp64 projection, fp32 select and replay --------
    rows = []
    n = S * NB * D

    def row(name, line, dtype, fn, plain, lib, rows_for_norm, nbytes, flops,
            **extra):
        got, want = fn(), plain()
        err = compare(torch, got, want, rows_for_norm, dtype)
        del got, want
        rows.append(kernel_row(
            torch, name, "gbatc_kernels.cu",
            f"src/repro/kernels/gbatc_project.py:{line}", fn, plain, lib,
            str(dtype).split(".")[-1], (S, NB, D), nbytes, flops, launches,
            max(err, ragged_err[name, dtype]), ragged_shapes_checked=RAGGED,
            tolerance=("max abs diff <= 1e-12 x row l2 norm"
                       if dtype == torch.float64 else "max abs diff <= 1e-5"),
            **extra))

    for i, (s, nb) in enumerate(PARTIAL_CORRECT_SHAPES):
        x, c, u, _, _ = make_inputs(torch, s, nb, D, torch.float32, 150 + i)
        note("gbatc_correct_batched", torch.float32, compare(
            torch, gk.gbatc_correct_batched(x, c, u),
            kref.gbatc_correct_batched_ref(x, c, u), c, torch.float32))
    del x, c, u

    x, c, u, rank, m = make_inputs(torch, S, NB, D, torch.float64, 1)
    same_twice(torch, "gbatc_project_batched (fp64)",
               lambda: gk.gbatc_project_batched(x, u))
    same_rows(torch, "gbatc_project_batched (fp64)", gk.gbatc_project_batched(x, u),
              [((slice(None), slice(a, b)), gk.gbatc_project_batched(
                  x[:, a:b].contiguous(), u)) for a, b in PROJECT_SUBRANGES]
              + [((slice(1, 3),), gk.gbatc_project_batched(
                  x[1:3].contiguous(), u[1:3].contiguous()))])
    row("gbatc_project_batched", 207, torch.float64,
        lambda: gk.gbatc_project_batched(x, u),
        lambda: kref.gbatc_project_batched_ref(x, u),
        lambda: torch.bmm(x, u), x,
        (2 * n + S * D * D) * 8, 2 * n * D)
    del x, c, u, rank, m
    torch.cuda.empty_cache()

    x, c, u, rank, m = make_inputs(torch, S, NB, D, torch.float32, 2)
    # the fp32 projection is part of the kernel's contract too
    compare(torch, gk.gbatc_project_batched(x, u),
            kref.gbatc_project_batched_ref(x, u), x, torch.float32)
    fp32_pair_bits(torch, gk, x, c, u, rank, m)
    kept = int((rank < m[..., None]).sum())
    row("gbatc_select_accumulate", 288, torch.float32,
        lambda: gk.gbatc_select_accumulate(x, c, rank, m, u),
        lambda: kref.gbatc_select_accumulate_ref(x, c, rank, m, u),
        None, c,
        (4 * n + S * NB + S * D * D) * 4, 2 * kept * D)
    ut = u.transpose(1, 2)
    row("gbatc_correct_batched", 240, torch.float32,
        lambda: gk.gbatc_correct_batched(x, c, u),
        lambda: kref.gbatc_correct_batched_ref(x, c, u),
        lambda: torch.baddbmm(x, c, ut), c,
        (3 * n + S * D * D) * 4, 2 * n * D,
        partial_shapes_checked=PARTIAL_CORRECT_SHAPES)
    del x, c, u, rank, m, ut
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "launches_timed": launches,
          "summary": [{k: r[k] for k in ("name", "dtype", "max_abs_err", "ms",
                                         "plain_ms", "library_ms", "bound_ms")}
                      for r in rows]})
    return rows


def phase_flash(torch, launches: int) -> dict:
    """The flash-attention kernel against its plain version on every shape
    of FLASH_SHAPES and at the attention path's shape, where it is timed."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref as kref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def qkv(b, h, tq, tk, d, dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
                for t in (tq, tk, tk)]

    def check(q, k, v, causal, window, dtype_name):
        got = fk.flash_attention(q, k, v, causal=causal, window=window)
        want = kref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if got.dtype != q.dtype or got.shape != q.shape:
            fail(f"flash_attention returned {got.dtype}{tuple(got.shape)}")
        if not torch.isfinite(got).all():
            fail("flash_attention output is not finite")
        err = float((got.float() - want.float()).abs().max())
        if err > FLASH_LIMIT[dtype_name]:
            fail(f"flash_attention differs from its plain version by {err:.3e} "
                 f"({dtype_name}, shape {tuple(q.shape)}/{k.shape[2]}, "
                 f"causal={causal}, window={window})")
        return err

    errs = {"float32": 0.0, "bfloat16": 0.0}
    for i, (b, h, tq, tk, d, causal, window, dtypes) in enumerate(FLASH_SHAPES):
        for name in dtypes:
            q, k, v = qkv(b, h, tq, tk, d, getattr(torch, name), 200 + i)
            errs[name] = max(errs[name], check(q, k, v, causal, window, name))

    b, h, t, d = FLASH_PATH
    q, k, v = qkv(b, h, t, t, d, torch.bfloat16, 300)
    errs["bfloat16"] = max(errs["bfloat16"], check(q, k, v, False, 0, "bfloat16"))
    ms_bf16 = time_ms(torch, lambda: fk.flash_attention(q, k, v, causal=False),
                      launches)
    q, k, v = qkv(b, h, t, t, d, torch.float32, 301)
    err = check(q, k, v, False, 0, "float32")
    same_twice(torch, "flash_attention", lambda: fk.flash_attention(q, k, v, causal=False))
    # the codec encodes in 512-block batches and decodes in 4096-block ones
    same_rows(torch, "flash_attention", fk.flash_attention(q, k, v, causal=False),
              [(slice(0, 512), fk.flash_attention(q[:512], k[:512], v[:512],
                                                  causal=False)),
               (slice(1000, 1003), fk.flash_attention(
                   q[1000:1003].contiguous(), k[1000:1003].contiguous(),
                   v[1000:1003].contiguous(), causal=False))])
    plain = lambda: kref.flash_attention_ref(q, k, v, causal=False)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    n = b * h * t * d
    row = kernel_row(
        torch, "flash_attention", "flash_attention.cu",
        "src/repro/kernels/flash_attention.py:116",
        lambda: fk.flash_attention(q, k, v, causal=False), plain, sdpa,
        "float32", FLASH_PATH, 4 * n * 4, 4 * b * h * t * t * d, launches,
        max(err, errs["float32"]), causal=False,
        max_abs_err_bf16=errs["bfloat16"], ms_bf16=ms_bf16,
        library_max_abs_err=float((sdpa() - plain()).abs().max()),
        shapes_checked=[list(c[:7]) + [list(c[7])] for c in FLASH_SHAPES],
        tolerance="max abs diff <= 2e-5 (fp32), 2e-2 (bf16)")
    del q, k, v
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "flash_attention",
          "launches_timed": launches,
          "summary": {k: row[k] for k in ("max_abs_err", "max_abs_err_bf16",
                                          "ms", "ms_bf16", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")}})
    return row


def phase_ops_kernels(torch, launches: int) -> list[dict]:
    """The 2D GBATC pair, block_quant, rwkv6_scan and rglru_scan against
    their plain versions on the card: at the reference's sweeps, ragged
    shapes and bf16 (the 2D pair: fp64), then at the full-width shapes,
    where each is timed. Returns their rows in that order."""
    from repro_torch.kernels import block_quant as bk
    from repro_torch.kernels import gbatc_project as gk
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import rglru_scan as rk
    from repro_torch.kernels import rwkv6_scan as wk

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(500)
    f32, bf16 = torch.float32, torch.bfloat16
    t_start = time.perf_counter()

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    rows = []

    # -- 2D GBATC pair: the batched kernels' project mode and masked mode at
    # S = 1, held to their fp32 and fp64 limits --------------------------
    def gbatc_inputs(nb, d, dtype):
        q, _ = torch.linalg.qr(randn(d, d, dtype=torch.float64))
        mask = (torch.rand(nb, d, generator=g, device="cuda") < 0.5).to(dtype)
        return (randn(nb, d, dtype=dtype), randn(nb, d, dtype=dtype),
                q.to(dtype).contiguous(), mask)

    err = {"gbatc_project": 0.0, "gbatc_correct": 0.0}
    for nb, d in GBATC_2D_SWEEP:
        for dtype in (f32, torch.float64):
            x, c, u, mask = gbatc_inputs(nb, d, dtype)
            e_p = compare(torch, gk.gbatc_project(x, u),
                          kref.gbatc_project_ref(x, u), x, dtype)
            # a bool mask, converted by the wrapper as the reference's astype
            e_c = compare(torch, gk.gbatc_correct(x, c, mask.bool(), u),
                          kref.gbatc_correct_ref(x, c, mask, u), c, dtype)
            if dtype == f32:
                err["gbatc_project"] = max(err["gbatc_project"], e_p)
                err["gbatc_correct"] = max(err["gbatc_correct"], e_c)
    nb, d = GBATC_2D
    n = nb * d
    x, c, u, mask = gbatc_inputs(nb, d, f32)
    e_p = compare(torch, gk.gbatc_project(x, u), kref.gbatc_project_ref(x, u), x, f32)
    e_c = compare(torch, gk.gbatc_correct(x, c, mask, u),
                  kref.gbatc_correct_ref(x, c, mask, u), c, f32)
    same_twice(torch, "gbatc_project", lambda: gk.gbatc_project(x, u))
    same_rows(torch, "gbatc_project", gk.gbatc_project(x, u),
              [(slice(a, b), gk.gbatc_project(x[a:b].contiguous(), u))
               for a, b in PROJECT_2D_SUBRANGES])
    same_twice(torch, "gbatc_correct", lambda: gk.gbatc_correct(x, c, mask, u))
    gbatc_extra = {"shapes_checked": GBATC_2D_SWEEP, "dtypes_checked": ["float32", "float64"],
                   "subranges_checked": PROJECT_2D_SUBRANGES,
                   "tolerance": "max abs diff <= 1e-5 (fp32); <= 1e-12 x row l2 norm (fp64)"}
    rows.append(kernel_row(
        torch, "gbatc_project", "gbatc_kernels.cu",
        "src/repro/kernels/gbatc_project.py:105",
        lambda: gk.gbatc_project(x, u), lambda: kref.gbatc_project_ref(x, u),
        lambda: torch.mm(x, u), "float32", GBATC_2D, (2 * n + d * d) * 4,
        2 * n * d, launches, max(e_p, err["gbatc_project"]), **gbatc_extra))
    kept = int(mask.sum())
    rows.append(kernel_row(
        torch, "gbatc_correct", "gbatc_kernels.cu",
        "src/repro/kernels/gbatc_project.py:140",
        lambda: gk.gbatc_correct(x, c, mask, u),
        lambda: kref.gbatc_correct_ref(x, c, mask, u), None, "float32",
        GBATC_2D, (4 * n + d * d) * 4, 2 * kept * d, launches,
        max(e_c, err["gbatc_correct"]), mask_kept=kept, **gbatc_extra))
    del x, c, u, mask

    # -- block_quant: bitwise, fp32 and bf16 -------------------------------
    shape, n_bits, block = BQ_PATH
    for sh, blk in BQ_SWEEP + [(shape, block)]:
        for bits in (4, 8):
            for dtype in (f32, bf16):
                xq = randn(*sh, dtype=dtype)
                out, sc = bk.block_quant(xq, n_bits=bits, block=blk)
                want, want_sc = kref.block_quant_ref(xq, n_bits=bits, block=blk)
                if not (torch.equal(out, want) and torch.equal(sc, want_sc)):
                    fail(f"block_quant differs from its plain version at {sh}, "
                         f"block {blk}, {bits} bits, {dtype}: max abs "
                         f"{float((out.float() - want.float()).abs().max()):.3e}")
    xq = randn(*shape)
    numel = xq.numel()
    same_twice(torch, "block_quant", lambda: bk.block_quant(xq, n_bits=n_bits, block=block))
    rows.append(kernel_row(
        torch, "block_quant", "block_quant.cu", "src/repro/kernels/block_quant.py:53",
        lambda: bk.block_quant(xq, n_bits=n_bits, block=block),
        lambda: kref.block_quant_ref(xq, n_bits=n_bits, block=block), None,
        "float32", shape, 2 * numel * 4 + numel // block * 4, 4 * numel, launches,
        0.0, n_bits=n_bits, block=block,
        shapes_checked=[[list(sh), blk] for sh, blk in BQ_SWEEP], bits_checked=[4, 8],
        dtypes_checked=["float32", "bfloat16"],
        tolerance="bitwise (out and scales), fp32 and bf16"))
    del xq

    # -- rwkv6_scan --------------------------------------------------------
    def rw_inputs(b, t, h, n, dtype, decay=None, carried=True):
        r, k, v = (randn(b, t, h, n, dtype=dtype) for _ in range(3))
        if decay is None:
            w = torch.sigmoid(3.0 * randn(b, t, h, n)).clamp(1e-6, 1 - 1e-6)
        else:
            w = torch.full((b, t, h, n), decay, device="cuda")
        # a random s0 is not symmetric, so a transposed state would show
        s0 = randn(b, h, n, n) if carried else None
        return r, k, v, w.to(dtype), (0.5 * randn(h, n)).to(dtype), s0

    def rw_check(args, what) -> float:
        out, s_last = wk.rwkv6_scan(*args)
        want, want_last = kref.rwkv6_scan_ref(*args)
        if not (torch.isfinite(out).all() and torch.isfinite(s_last).all()):
            fail(f"rwkv6_scan output is not finite ({what})")
        top = max(1.0, float(want.float().abs().max()))
        limit = RWKV_LIMIT * top + (BF16_ULP * top if out.dtype == bf16 else 0.0)
        e = float((out.float() - want.float()).abs().max())
        e_s = float((s_last - want_last).abs().max())
        if e > limit or e_s > RWKV_LIMIT * max(1.0, float(want_last.abs().max())):
            fail(f"rwkv6_scan differs from its plain version ({what}): out "
                 f"{e:.3e} (limit {limit:.3e}), S_T {e_s:.3e}")
        return max(e, e_s)

    rw_err = 0.0
    for b, t, h, n in RWKV_SWEEP + [RWKV_PATH]:
        for dtype in (f32, bf16):
            e = rw_check(rw_inputs(b, t, h, n, dtype), f"{(b, t, h, n)} {dtype}")
            rw_err = max(rw_err, e) if dtype == f32 else rw_err
    rw_check(rw_inputs(1, 64, 1, 16, f32, decay=1e-30, carried=False), "w = 1e-30")
    above = rw_inputs(1, 16, 1, 16, f32, decay=1.5)
    rw_check(above, "w = 1.5")
    at_one = above[:3] + (torch.ones_like(above[3]),) + above[4:]
    if not all(torch.equal(a, b) for a, b in zip(wk.rwkv6_scan(*above), wk.rwkv6_scan(*at_one))):
        fail("rwkv6_scan does not clamp w > 1 to 1")
    b, t, h, n = RWKV_PATH
    args = rw_inputs(b, t, h, n, f32)
    rw_err = max(rw_err, rw_check(args, "timed shape"))
    same_twice(torch, "rwkv6_scan", lambda: wk.rwkv6_scan(*args))
    full = wk.rwkv6_scan(*args)
    part = wk.rwkv6_scan(*(a if i == 4 else a[:2].contiguous()  # u has no batch
                           for i, a in enumerate(args)))
    for what, f, p in zip(("out", "S_T"), full, part):
        same_rows(torch, f"rwkv6_scan ({what})", f, [(slice(0, 2), p)])
    del full, part
    tokens = b * t * h
    rows.append(kernel_row(
        torch, "rwkv6_scan", "rwkv6_scan.cu", "src/repro/kernels/rwkv6_scan.py:111",
        lambda: wk.rwkv6_scan(*args), lambda: kref.rwkv6_scan_ref(*args), None,
        "float32", RWKV_PATH, 5 * tokens * n * 4 + 2 * b * h * n * n * 4 + h * n * 4,
        5 * tokens * n * n, launches, rw_err, plain_launches=3, initial_state="random (B,H,N,N)",
        shapes_checked=RWKV_SWEEP, dtypes_checked=["float32", "bfloat16"],
        extra_cases=["w = 1e-30", "w = 1.5 (clamped to 1)"], subranges_checked=["batch 0-1"],
        tolerance="max abs diff <= 2e-4 x max(1, max|plain|) (+ one bf16 ulp of it in bf16)"))
    del args

    # -- rglru_scan --------------------------------------------------------
    def rg_check(a, bb, h0, what) -> tuple:
        h, h_last = rk.rglru_scan(a, bb, h0)
        want, want_last = kref.rglru_scan_ref(a, bb, h0)
        if not (torch.isfinite(h).all() and torch.isfinite(h_last).all()):
            fail(f"rglru_scan output is not finite ({what})")
        e = max(float((h.float() - want.float()).abs().max()),
                float((h_last - want_last).abs().max()))
        if e > RGLRU_LIMIT:
            fail(f"rglru_scan differs from its plain version ({what}): {e:.3e}")
        return e, h

    def rg_inputs(b, t, w, dtype):
        return (torch.sigmoid(2.0 + randn(b, t, w)).to(dtype),
                randn(b, t, w, dtype=dtype), randn(b, w))

    rg_err = 0.0
    for b, t, w in RGLRU_SWEEP + [RGLRU_PATH]:
        for dtype in (f32, bf16):
            e, _ = rg_check(*rg_inputs(b, t, w, dtype), f"{(b, t, w)} {dtype}")
            rg_err = max(rg_err, e) if dtype == f32 else rg_err
    ones = torch.ones(1, 32, 16, device="cuda")
    rg_check(torch.full_like(ones, 1e-25), ones, None, "a = 1e-25")
    _, h = rg_check(torch.full_like(ones, 1.5), ones, None, "a = 1.5")
    if float(h[0, -1, 0]) != 32.0:
        fail("rglru_scan does not clamp a > 1 to 1")
    b, t, w = RGLRU_PATH
    a, bb, h0 = rg_inputs(b, t, w, f32)
    e, _ = rg_check(a, bb, h0, "timed shape")
    same_twice(torch, "rglru_scan", lambda: rk.rglru_scan(a, bb, h0))
    n = b * t * w
    rows.append(kernel_row(
        torch, "rglru_scan", "rglru_scan.cu", "src/repro/kernels/rglru_scan.py:75",
        lambda: rk.rglru_scan(a, bb, h0), lambda: kref.rglru_scan_ref(a, bb, h0),
        None, "float32", RGLRU_PATH, 3 * n * 4 + 2 * b * w * 4, 2 * n, launches,
        max(rg_err, e), plain_launches=3, shapes_checked=RGLRU_SWEEP,
        dtypes_checked=["float32", "bfloat16"],
        extra_cases=["a = 1e-25", "a = 1.5 (clamped to 1)"],
        tolerance="max abs diff <= 1e-5 at unit-scale inputs"))
    del a, bb, h0
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernels": [r["name"] for r in rows],
          "launches_timed": launches, "seconds": time.perf_counter() - t_start,
          "summary": [{k: r[k] for k in ("name", "max_abs_err", "ms", "plain_ms",
                                         "library_ms", "bound_ms", "bound_by")}
                      for r in rows]})
    return rows


def phase_ops_path(torch) -> dict:
    """Each ``repro_torch.kernels.ops.*_op`` once at its full-width shape,
    from numpy inputs on the default device, held against its plain
    version; launch counts are reset just before each call and read just
    after it: each call launches its own kernel once and nothing else."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(600)
    t_start = time.perf_counter()

    def host(*shape, fn=None):
        t = torch.randn(*shape, generator=g, device="cuda")
        return (t if fn is None else fn(t)).cpu().numpy()

    def dev(*arrays):
        return [torch.from_numpy(a).cuda() for a in arrays]

    calls: dict = {}

    def call(op, kernel, fn, plain, limit_of):
        reset_counts()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = all_counts()
        if counts[kernel] != 1 or any(v for k, v in counts.items() if k != kernel):
            fail(f"ops_path: {op} launched {counts}; expected one launch of "
                 f"{kernel} and nothing else")
        got = got if isinstance(got, tuple) else (got,)
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for a, b in zip(got, want, strict=True):
            if a.shape != b.shape or a.dtype != b.dtype or a.device.type != "cuda":
                fail(f"ops_path: {op} returned {a.dtype}{tuple(a.shape)} on "
                     f"{a.device}, its plain version {b.dtype}{tuple(b.shape)}")
            if not torch.isfinite(a).all():
                fail(f"ops_path: {op} output is not finite")
            err = max(err, float((a.float() - b.float()).abs().max()))
        limit = limit_of(want)
        if err > limit:
            fail(f"ops_path: {op} differs from its plain version by {err:.3e} "
                 f"(limit {limit:.3e})")
        calls[op] = {"kernel": kernel, "launches": counts, "seconds": seconds,
                     "max_abs_err": err, "limit": limit}

    nb, d = GBATC_2D
    x, c = host(nb, d), host(nb, d)
    u = torch.linalg.qr(torch.randn(d, d, generator=g, device="cuda",
                                    dtype=torch.float64))[0].float().cpu().numpy()
    mask = (torch.rand(nb, d, generator=g, device="cuda") < 0.5).float().cpu().numpy()
    call("gbatc_project_op", "gbatc_project", lambda: ops.gbatc_project_op(x, u),
         lambda: kref.gbatc_project_ref(*dev(x, u)), lambda w: FP32_LIMIT)
    call("gbatc_correct_op", "gbatc_correct",
         lambda: ops.gbatc_correct_op(x, c, mask, u),
         lambda: kref.gbatc_correct_ref(*dev(x, c, mask, u)), lambda w: FP32_LIMIT)
    del x, c, mask

    shape, n_bits, block = BQ_PATH
    xq = host(*shape)
    call("block_quant_op", "block_quant",
         lambda: ops.block_quant_op(xq, n_bits=n_bits, block=block),
         lambda: kref.block_quant_ref(*dev(xq), n_bits=n_bits, block=block),
         lambda w: 0.0)
    del xq

    b, t, h, n = RWKV_PATH
    r, k, v = (host(b, t, h, n) for _ in range(3))
    w = host(b, t, h, n, fn=lambda z: torch.sigmoid(3.0 * z).clamp(1e-6, 1 - 1e-6))
    uu, s0 = host(h, n, fn=lambda z: 0.5 * z), host(b, h, n, n)
    call("rwkv6_scan_op", "rwkv6_scan", lambda: ops.rwkv6_scan_op(r, k, v, w, uu, s0),
         lambda: kref.rwkv6_scan_ref(*dev(r, k, v, w, uu, s0)),
         lambda want: RWKV_LIMIT * max(1.0, *(float(a.abs().max()) for a in want)))
    del r, k, v, w, uu, s0

    b, t, wd = RGLRU_PATH
    a = host(b, t, wd, fn=lambda z: torch.sigmoid(2.0 + z))
    bb, h0 = host(b, t, wd), host(b, wd)
    call("rglru_scan_op", "rglru_scan", lambda: ops.rglru_scan_op(a, bb, h0),
         lambda: kref.rglru_scan_ref(*dev(a, bb, h0)), lambda w: RGLRU_LIMIT)
    del a, bb, h0

    qb, qh, qt, qd = FLASH_PATH
    q, kk, vv = (host(qb, qh, qt, qd) for _ in range(3))
    call("flash_attention_op", "flash_attention",
         lambda: ops.flash_attention_op(q, kk, vv, causal=False),
         lambda: kref.flash_attention_ref(*dev(q, kk, vv), causal=False),
         lambda w: FLASH_LIMIT["float32"])
    del q, kk, vv
    torch.cuda.empty_cache()
    info = {"phase": "ops_path", "calls": calls,
            "seconds": time.perf_counter() - t_start}
    emit(info)
    return calls


def _wrappers() -> list:
    from repro_torch.kernels import block_quant, flash_attention, gbatc_project
    from repro_torch.kernels import rglru_scan, rwkv6_scan

    return [gbatc_project, flash_attention, block_quant, rglru_scan, rwkv6_scan]


def all_counts() -> dict:
    return {k: n for w in _wrappers() for k, n in w.launch_counts().items()}


def reset_counts() -> None:
    for w in _wrappers():
        w.reset_launches()


def generate(args):
    from repro_torch.data import s3d

    t0 = time.perf_counter()
    data = s3d.generate(s3d.S3DConfig(
        n_species=58, n_time=args.frames, height=args.height, width=args.width,
        seed=args.seed))["species"]
    return data, time.perf_counter() - t0


def drive(torch, data, cfg, args, name: str, widths: dict,
          ae_steps: int) -> tuple:
    """Fit + compress at 1e-3, decompress from the bytes, a second bound on
    the same fit, with every gate of the path; returns (info, blob,
    artifact, field): the path line, the 1e-3 blob, its artifact and its
    decoded field. Launch counts are reset just before each of the three
    calls and read just after it."""
    import numpy as np

    from repro_torch import codec
    from repro_torch.core import metrics
    from repro_torch.core.pipeline import GBATCCodec

    target = 1e-3
    torch.cuda.reset_peak_memory_stats()
    gb = GBATCCodec(cfg)
    reset_counts()
    t0 = time.perf_counter()
    blob, rep = gb.compress_report(data, target_nrmse=target)
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    compress_counts = all_counts()
    stage_s = json.loads(json.dumps(gb.pipeline.timings))  # deep copy
    reset_counts()
    t0 = time.perf_counter()
    field = codec.decompress(blob)
    torch.cuda.synchronize()
    decompress_s = time.perf_counter() - t0
    decompress_counts = all_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # host share of the decode: a fresh parse + entropy decode of every
    # stream, no network and no kernel (not part of the counted path)
    t0 = time.perf_counter()
    codec.decode_artifact(blob)
    parse_s = time.perf_counter() - t0

    # -- the result is right, by the repo's own means ----------------------
    s = data.shape[0]
    if field.shape != data.shape or field.dtype != np.float32:
        fail(f"{name}: decompressed field is {field.dtype}{field.shape}")
    if not np.isfinite(field).all():
        fail(f"{name}: decompressed field is not finite")
    nrmse = np.array([metrics.nrmse(data[i], field[i]) for i in range(s)])
    if not (nrmse <= target * (1 + 1e-3)).all():
        fail(f"{name}: per-species NRMSE bound missed: max {nrmse.max():.4e} > {target}")
    if not np.array_equal(field, rep.recon):
        fail(f"{name}: decompress(blob) differs from the compress report's "
             f"recon (max abs {np.abs(field - rep.recon).max():.3e})")
    if len(blob) != rep.bytes_breakdown["total"]:
        fail(f"{name}: len(blob) != byte breakdown total")
    launches = {k: compress_counts[k] + decompress_counts[k] for k in compress_counts}
    for kernel in ("gbatc_project_batched", "gbatc_select_accumulate",
                   "gbatc_correct_batched"):
        if launches[kernel] < 1:
            fail(f"kernel {kernel} was never launched on {name}")

    # -- a second bound on the same fit reuses the prepared state ---------
    reset_counts()
    t0 = time.perf_counter()
    blob2, rep2 = gb.compress_report(target_nrmse=1e-2)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    second_counts = all_counts()
    if second_counts["gbatc_project_batched"]:
        fail(f"{name}: second compress launched the projection again "
             "(prepare not reused)")
    # the guarantee's reconstruction: one select a compress, one replay a
    # decompress
    for kernel, part, counts in (
            ("gbatc_select_accumulate", "compress", compress_counts),
            ("gbatc_select_accumulate", "second compress", second_counts),
            ("gbatc_correct_batched", "decompress", decompress_counts)):
        if counts[kernel] != 1:
            fail(f"{name}: {kernel} launched {counts[kernel]} times in {part}, "
                 "expected once")
    if not (rep2.per_species_nrmse <= 1e-2 * (1 + 1e-3)).all():
        fail(f"{name}: second compress (1e-2) missed its bound")
    backends = select_backends_agree(gb.pipeline, name, (target, 1e-2))

    info = {
        "phase": name, "family": cfg.family, "shape": list(data.shape),
        "cut": {"frames": args.frames, "height": args.height,
                "width": args.width, "of_paper": [50, 640, 640],
                "ae_steps": ae_steps, "corr_steps": args.corr_steps},
        "widths": widths,
        "compress_s": compress_s,
        "decompress_s": decompress_s, "decode_artifact_s": parse_s,
        "second_compress_s": second_s,
        "timings_s": stage_s,
        "second_timings_s": {k: gb.pipeline.timings[k] for k in (
            "select", "encode", "report", "compress_total")},
        "max_nrmse": float(nrmse.max()), "target_nrmse": target,
        "compression_ratio": rep.compression_ratio, "blob_bytes": len(blob),
        "breakdown": rep.bytes_breakdown,
        "second_blob_bytes": len(blob2),
        "recon_sha256": hashlib.sha256(rep.recon.tobytes()).hexdigest(),
        "blob_sha256": hashlib.sha256(blob).hexdigest(),
        "launches": launches,
        "launches_compress": compress_counts,
        "launches_decompress": decompress_counts,
        "launches_second_compress": second_counts,
        "peak_device_gb": peak_gb,
        "select_backends": backends,
    }
    return info, blob, rep.artifact, field


def select_backends_agree(pipe, name: str, bounds) -> dict:
    """The engine's device select backend (the default on CUDA: fp64 torch
    ops, the gain cumsum a parallel scan) against its host backend (numpy,
    the oracle's sequential cumsum) on the path's own prepared state, at
    each bound: coeff_q, the CSR index (offsets and flat) and basis of every
    species, and the corrected reconstruction, must be equal byte for byte.
    Reports the blocks whose cut m_eff differs (the kept count of a block);
    any difference fails the run."""
    import numpy as np

    from repro_torch.core import gae

    entries = list(pipe._prepared.values())
    if len(entries) != 1:
        fail(f"{name}: expected one prepared guarantee state, found {len(entries)}")
    prepared = entries[0][0]
    device_engine = pipe._gengine
    if device_engine.select_backend != "device":
        fail(f"{name}: the engine's select backend is {device_engine.select_backend!r}")
    host_engine = gae.GuaranteeEngine(device_engine.device, select_backend="host")
    d = prepared.shape[2]
    differ, unequal = [], []
    for bound in bounds:
        tau = bound * np.sqrt(d)  # as the pipeline's compress: range 1
        rec_d, arts_d = device_engine.select(prepared, tau)
        rec_h, arts_h = host_engine.select(prepared, tau)
        n = 0
        for sp, (a, b) in enumerate(zip(arts_d, arts_h, strict=True)):
            n += int((np.diff(a.index_offsets) != np.diff(b.index_offsets)).sum())
            for field in ("coeff_q", "index_offsets", "index_flat", "basis"):
                x, y = getattr(a, field), getattr(b, field)
                if not (x.dtype == y.dtype and x.shape == y.shape
                        and x.tobytes() == y.tobytes()):
                    unequal.append(f"{field} of species {sp} at {bound:g}")
        if rec_d.tobytes() != rec_h.tobytes():
            unequal.append(f"corrected reconstruction at {bound:g}")
        differ.append(n)
    info = {"bounds": list(bounds), "blocks_m_eff_differ": differ,
            "artifacts_equal": not unequal}
    if unequal or any(differ):
        fail(f"{name}: device and host select backends differ: {differ} blocks' "
             f"m_eff at {list(bounds)}; unequal: {unequal[:8]}")
    return info


def phase_main_path(torch, args, data) -> dict:
    from repro_torch.core.pipeline import PipelineConfig

    cfg = PipelineConfig(latent=36, conv_channels=(32, 64), use_correction=True,
                         ae_steps=args.ae_steps, corr_steps=args.corr_steps,
                         seed=args.seed)
    info, blob, artifact, field = drive(torch, data, cfg, args, "main_path", {
        "species": 58, "block": [4, 5, 4], "latent": 36,
        "conv_channels": [32, 64], "correction": [232, 464, 232]}, args.ae_steps)
    emit(info)
    return info, blob, artifact, field


def phase_attention_path(torch, args, data) -> dict:
    from repro_torch.core.container import ContainerReader
    from repro_torch.core.pipeline import PipelineConfig

    cfg = PipelineConfig(family="attention", arch=(32, 2, 1, 64), latent=36,
                         use_correction=True, ae_steps=args.attn_ae_steps,
                         corr_steps=args.corr_steps, seed=args.seed)
    info, blob, _, field = drive(torch, data, cfg, args, "attention_path", {
        "species": 58, "block": [4, 5, 4], "latent": 36,
        "arch": {"d_model": 32, "n_heads": 2, "depth": 1, "mlp_hidden": 64},
        "tokens": 232, "head_dim": 16, "correction": [232, 464, 232]},
        args.attn_ae_steps)
    tag = ContainerReader(blob)["meta"][0]
    if tag != 2:
        fail(f"attention_path: blob's family tag is {tag}, expected 2")
    if info["launches_compress"]["flash_attention"] < 1:
        fail("flash_attention was never launched during compress")
    if info["launches_decompress"]["flash_attention"] < 1:
        fail("flash_attention was never launched during decompress")
    info["family_tag"] = tag
    emit(info)
    return info, blob, field


# partial_path: the conv blob's selections (species, frame window); None
# is every species or every frame. Then PARTIAL_RANDOM seeded random pairs
# of at most PARTIAL_RANDOM_SPECIES species, so that a cold decode's host
# entropy work stays a fraction of a full decode's.
PARTIAL_SELECTIONS = [([0, 29, 57], (4, 12)), (5, None), (-1, None),
                      (None, (0, 4)), ([3], (13, 16))]
PARTIAL_RANDOM, PARTIAL_RANDOM_SPECIES = 8, 8
FLIPS_PER_REGION = 2  # seeded single-bit flips per region of the blob
GBATC_KERNELS = ("gbatc_project_batched", "gbatc_select_accumulate",
                 "gbatc_correct_batched", "gbatc_project", "gbatc_correct")


def sliced(field, species, window):
    """``field[species, t0:t1]`` as a selective decode returns it (an int
    species squeezes the species axis)."""
    import numpy as np

    t0, t1 = window if window is not None else (0, field.shape[1])
    if species is None:
        out = field[:, t0:t1]
    elif isinstance(species, int):
        out = field[species, t0:t1]
    else:
        out = field[list(species)][:, t0:t1]
    return np.ascontiguousarray(out)


def counted(torch, fn) -> tuple:
    """Run ``fn`` with the launch counts reset just before and read just
    after; returns (result, seconds, counts)."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, all_counts()


def raised(fn, what: str):
    """The ContainerFormatError ``fn`` must raise; fails the run when it
    returns instead (any other exception propagates and fails it too)."""
    from repro_torch.core.container import ContainerFormatError

    try:
        fn()
    except ContainerFormatError as e:
        return e
    fail(f"partial_path: {what} decoded without raising ContainerFormatError")


def phase_partial_path(torch, conv: tuple, attention: tuple) -> dict:
    """Selective decode, old container versions and integrity/salvage of
    the port on the card, on the two codec paths' blobs (no new fit):
    ``conv`` is (blob, artifact, field), ``attention`` (blob, field). Every
    decode below runs with the launch counts reset just before it and read
    just after; their sums per kernel go into each kernel row's
    ``launches_by_path``."""
    import numpy as np

    from repro_torch import codec
    from repro_torch.codec import format as wire
    from repro_torch.codec import runtime
    from repro_torch.core.container import ContainerReader, ContainerWriter
    from repro_torch.testing.faults import FaultInjector, blob_regions

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    blob, artifact, field = conv
    s_all, t_all = field.shape[:2]
    totals: dict = {}

    def tally(part: str, counts: dict) -> None:
        acc = totals.setdefault(part, dict.fromkeys(counts, 0))
        for k, n in counts.items():
            acc[k] += n

    def one_replay(counts: dict, what: str, flash: bool = False) -> None:
        """Exactly one replay launch, no other GBATC kernel; flash at least
        once on an attention blob and never on a conv blob."""
        others = {k: n for k, n in counts.items()
                  if k not in ("gbatc_correct_batched", "flash_attention") and n}
        if counts["gbatc_correct_batched"] != 1 or others or \
                (counts["flash_attention"] >= 1) != flash:
            fail(f"partial_path: {what} launched {counts}; expected one "
                 f"gbatc_correct_batched{' and flash_attention' if flash else ''} "
                 "and no other kernel")

    def bitwise(got, want, what: str) -> None:
        if got.shape != want.shape or got.dtype != want.dtype or \
                got.tobytes() != want.tobytes():
            diff = (float(np.nanmax(np.abs(got - want)))
                    if got.shape == want.shape else None)
            fail(f"partial_path: {what} is not bitwise the full decode's slice "
                 f"(got {got.dtype}{got.shape}, want {want.dtype}{want.shape}, "
                 f"max abs {diff})")

    # -- 1. selective decodes of the conv blob, cold then warm ------------
    rng = np.random.default_rng(17)
    selections = list(PARTIAL_SELECTIONS)
    for _ in range(PARTIAL_RANDOM):
        k = int(rng.integers(1, PARTIAL_RANDOM_SPECIES + 1))
        sel = sorted(int(i) for i in rng.choice(s_all, size=k, replace=False))
        t0 = int(rng.integers(0, t_all))
        selections.append((sel, (t0, int(rng.integers(t0 + 1, t_all + 1)))))
    pd = codec.PartialDecoder(blob)
    decodes = []
    for sel, win in selections:
        want = sliced(field, sel, win)
        codec.clear_decode_cache()
        rec = {"species": sel, "time_range": win}
        for mode in ("cold", "warm"):
            out, secs, counts = counted(torch, lambda: codec.decompress(
                blob, species=sel, time_range=win))
            what = f"decompress(species={sel}, time_range={win}) {mode}"
            bitwise(out, want, what)
            one_replay(counts, what)
            tally("selective", counts)
            rec[f"{mode}_s"] = secs
        rec["bytes_parsed"] = pd.bytes_parsed(sel, win)
        rec["latent_bytes_parsed"] = pd.latent_bytes_parsed(win)
        decodes.append(rec)
    one_group = pd.latent_bytes_parsed((0, 4))
    full_latent = pd.latent_bytes_parsed()
    if not one_group < full_latent:
        fail(f"partial_path: a one-block-group window parses {one_group} latent "
             f"bytes, the full decode {full_latent}")
    if pd.bytes_parsed() != len(blob):
        fail("partial_path: bytes_parsed() of the full selection != len(blob)")

    # -- row independence, measured: the window (4, 12) decoded at its own
    # rows from 0 (each row in another place of the same launch shapes)
    # against the full decode's rows; the selective path above runs the
    # full decode's geometry and is gated bitwise, this is a diagnostic
    head = runtime._cached_head(blob)
    lat = runtime._latents32(head.latents.full(), head.latent_bin)
    geom = head.cfg.geometry
    per_group = (head.shape[2] // geom.ph) * (head.shape[3] // geom.pw)
    b0, b1 = per_group, 3 * per_group  # frames 4-12
    whole = runtime._fused_vecs(head.runtime, head.dec_state, head.corr_state, lat)
    shifted = runtime._fused_vecs(head.runtime, head.dec_state, head.corr_state,
                                  lat[b0:b1])
    aligned = runtime._fused_vecs(head.runtime, head.dec_state, head.corr_state,
                                  lat[b0:b1], rows=(b0, head.nb))
    rows_info = {
        "window_rows": [b0, b1], "nb": head.nb,
        "shifted_equal": bool(torch.equal(shifted, whole[:, b0:b1])),
        "shifted_max_abs": float((shifted - whole[:, b0:b1]).abs().max()),
        "aligned_equal": bool(torch.equal(aligned, whole[:, b0:b1])),
    }
    if not rows_info["aligned_equal"]:
        fail("partial_path: a window in the full decode's geometry differs "
             "from the full decode's rows")
    del whole, shifted, aligned, lat

    # -- 2. the conv artifact at container v1-v4 ---------------------------
    versions = {}
    for version in (1, 2, 3, 4):
        t0 = time.perf_counter()
        old = codec.encode(artifact, version=version)
        enc_s = time.perf_counter() - t0
        if ContainerReader(old).version != version:
            fail(f"partial_path: encode(version={version}) wrote "
                 f"v{ContainerReader(old).version}")
        out, secs, counts = counted(torch, lambda: codec.decompress(
            old, species=[0, s_all - 1]))
        bitwise(out, sliced(field, [0, s_all - 1], None),
                f"v{version} decompress(species=[0, {s_all - 1}])")
        one_replay(counts, f"v{version} selective decode")
        tally("old_versions", counts)
        versions[version] = {"blob_bytes": len(old), "encode_s": enc_s,
                             "selective_s": secs}
        if version == 1:
            out, secs, counts = counted(torch, lambda: codec.decompress(old))
            bitwise(out, field, "v1 full decompress")
            one_replay(counts, "v1 full decompress")
            tally("old_versions", counts)
            versions[1]["full_decompress_s"] = secs
        if version == 3:
            r = ContainerReader(blob)
            w = ContainerWriter(version=3)
            for name in r.names:
                if name != "integrity":
                    w.add(name, r[name][1:] if name == "meta" else r[name])
            if w.to_bytes() != old:
                fail("partial_path: the v5 blob without its digests and family "
                     "tag is not the v3 blob")
        del old
    out, ref_s, counts = counted(torch, lambda: codec.decompress_reference(blob))
    bitwise(out, field, "decompress_reference(blob)")
    one_replay(counts, "decompress_reference")
    tally("old_versions", counts)

    # -- 3. integrity: verification, bit flips, raise mode, salvage --------
    t0 = time.perf_counter()
    if codec.verify_blob(blob) != 5:
        fail("partial_path: verify_blob(blob) != 5")
    verify_s = time.perf_counter() - t0
    regions = blob_regions(blob)
    inj = FaultInjector(seed=5)
    flips = detected = 0
    t0 = time.perf_counter()
    for reg in regions:
        for _ in range(FLIPS_PER_REGION):
            bad, fault = inj.flip_bit(blob, reg)
            flips += 1
            raised(lambda: codec.verify_blob(bad), f"verify_blob after {fault}")
            detected += 1
    flips_s = time.perf_counter() - t0

    def region(label):
        return next(r for r in regions if r.label == label)

    sel, win = [6, 7, 8], (0, 8)
    bad_species, _ = inj.flip_bit(blob, region("guarantee:s7:coeff"))
    bad_shard, _ = inj.flip_bit(blob, region("latent:shard1"))
    both, _ = inj.flip_bit(bad_species, region("latent:shard1"))
    raise_mode = {}
    for what, bad, want in (("species 7", bad_species, ("guarantee", 7)),
                            ("latent shard 1", bad_shard, ("latent", 1))):
        e = raised(lambda: codec.decompress(bad, species=sel, time_range=win),
                   f"a flip in {what}")
        if (e.stream, e.unit) != want:
            fail(f"partial_path: a flip in {what} raised naming "
                 f"({e.stream}, {e.unit}), expected {want}")
        raise_mode[what] = {"stream": e.stream, "unit": e.unit, "offset": e.offset}
    (salv, report), salvage_s, counts = counted(torch, lambda: codec.decompress(
        both, species=sel, time_range=win, on_error="salvage"))
    one_replay(counts, "salvage")
    tally("salvage", counts)
    clean = sliced(field, sel, win)
    d = ContainerReader(blob)
    ldir = wire.LatentShardDirectory(d["latent"])
    r0, r1 = ldir.shard_row_extent(1)
    damaged = [(r0 // per_group * geom.bt, r1 // per_group * geom.bt)]
    nan = np.zeros(salv.shape, bool)
    nan[1] = True  # species 7
    for lo, hi in damaged:
        nan[:, lo - win[0] : hi - win[0]] = True
    if report.quarantined != [7] or \
            [r.damaged_frames for i, r in sorted(report.species.items()) if i != 7] \
            != [damaged, damaged]:
        fail(f"partial_path: salvage reported quarantined {report.quarantined}, "
             f"{ {i: r.status for i, r in report.species.items()} }")
    if not np.isnan(salv[nan]).all() or salv[~nan].tobytes() != clean[~nan].tobytes():
        fail("partial_path: salvage is not NaN exactly in quarantine and bitwise "
             "the clean decode elsewhere")
    if runtime._head_key(both, torch.device("cuda", torch.cuda.current_device())) \
            in runtime._CACHE.heads:
        fail("partial_path: salvage left a head in the decode cache")

    # -- 4. one selective decode of the attention blob ---------------------
    a_blob, a_field = attention
    a_sel, a_win = [1, s_all // 2 + 1, s_all - 1], (4, 12)
    codec.clear_decode_cache()
    out, a_s, counts = counted(torch, lambda: codec.decompress(
        a_blob, species=a_sel, time_range=a_win))
    bitwise(out, sliced(a_field, a_sel, a_win), "attention selective decode")
    one_replay(counts, "attention selective decode", flash=True)
    tally("attention", counts)

    info = {
        "phase": "partial_path", "shape": list(field.shape),
        "selective": decodes,
        "latent_bytes_parsed": {"one_block_group": one_group, "full": full_latent},
        "row_independence": rows_info,
        "versions": versions, "decompress_reference_s": ref_s,
        "verify_blob_s": verify_s, "regions": len(regions),
        "flips": flips, "flips_detected": detected, "flips_s": flips_s,
        "raise_mode": raise_mode,
        "salvage": {"species": sel, "time_range": list(win), "seconds": salvage_s,
                    "quarantined": report.quarantined, "damaged_frames": damaged,
                    "failures": [(f.stream, f.unit, f.offset)
                                 for f in report.failures]},
        "attention": {"species": a_sel, "time_range": list(a_win), "cold_s": a_s},
        "launches": totals, "seconds": time.perf_counter() - t_start,
    }
    emit(info)
    return info


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="env,build,kernels,main_path,attention_path,ops_path,"
                            "partial_path")
    ap.add_argument("--launches", type=int, default=20,
                    help="timed launches per kernel (median reported)")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--ae-steps", type=int, default=200)
    ap.add_argument("--attn-ae-steps", type=int, default=300)
    ap.add_argument("--corr-steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    import repro_torch  # noqa: F401  (fails here when run outside a checkout)

    # a fresh build directory per run: the build phase proves a build from
    # the checkout's sources every time, and a re-run never fails on (or
    # reuses) an earlier run's libraries
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    build_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    os.environ["REPRO_TORCH_BUILD_DIR"] = build_dir
    try:
        run(torch, args, phases)
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)


def run(torch, args, phases) -> None:
    t_start = time.perf_counter()
    if "env" in phases:
        phase_env(torch)
    if "build" in phases:
        phase_build()
    rows = []
    if "kernels" in phases:
        launches = max(20, args.launches)
        batched = phase_kernels(torch, launches)
        flash = phase_flash(torch, launches)
        ops_rows = phase_ops_kernels(torch, launches)
        # the order of PERF.md's table of TPU kernels
        rows = batched + ops_rows[:2] + [flash] + ops_rows[2:]
    paths, outputs = {}, {}
    if "partial_path" in phases and not {"main_path", "attention_path"} <= set(phases):
        fail("partial_path needs the main_path and attention_path phases")
    if "main_path" in phases or "attention_path" in phases:
        data, gen_s = generate(args)
        emit({"phase": "generate", "shape": list(data.shape), "seconds": gen_s})
        if "main_path" in phases:
            paths["main_path"], *outputs["main_path"] = phase_main_path(
                torch, args, data)
        if "attention_path" in phases:
            paths["attention_path"], *outputs["attention_path"] = \
                phase_attention_path(torch, args, data)
        del data
    ops_calls = phase_ops_path(torch) if "ops_path" in phases else {}
    partial = (phase_partial_path(torch, outputs["main_path"],
                                  outputs["attention_path"])
               if "partial_path" in phases else None)
    outputs.clear()
    for r in rows:
        by_path = {p: {"compress": info["launches_compress"][r["name"]],
                       "decompress": info["launches_decompress"][r["name"]],
                       "second_compress": info["launches_second_compress"][r["name"]]}
                   for p, info in paths.items()}
        if ops_calls:
            by_path["ops_path"] = {op: c["launches"][r["name"]]
                                   for op, c in ops_calls.items()}
        if partial:
            by_path["partial_path"] = {part: c[r["name"]]
                                       for part, c in partial["launches"].items()}
        r["launches_by_path"] = by_path
        r["launches"] = sum(sum(c.values()) for c in by_path.values())
    complete = all(p in phases for p in ("build", "kernels", "main_path",
                                         "attention_path", "ops_path",
                                         "partial_path"))
    emit({"kernels": rows})
    print(gpu_line(), flush=True)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    if not complete:
        fail(f"only phases {phases} were run; the ok line needs all of them")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
