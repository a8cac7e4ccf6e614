#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the checkout root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. ``env``    card name and power limit, torch / CUDA / nvcc versions;
2. ``build``  compiles the CUDA kernels from the sources in the checkout;
3. ``kernels``  each kernel against its plain PyTorch version on the card at
   the main path's shapes (S=58, NB=20480, D=80) and at ragged shapes, with
   its time, the plain version's, the one-call library yardstick's and the
   card's bound for the same work;
4. ``main_path``  ``GBATCCodec.compress`` (fit + guarantee + container) and
   ``codec.decompress`` from the bytes alone at the paper's widths on an
   S3D surrogate of 58 x 16 x 320 x 320, with the kernels' launch counts
   reset just before and read just after;
5. the ``{"kernels": [...]}`` line, the card line, and the final ``ok`` line.

Without CUDA the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense, full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}  # fp64: tensor-core DMMA rate

S, NB, D = 58, 20480, 80  # main-path kernel shapes (T=16, 320x320, block 4x5x4)
RAGGED = [(3, 513, 80), (5, 513, 64), (2, 1, 80), (4, 100, 37)]
FP32_LIMIT = 1e-5  # max abs difference, unit-scale inputs, fp32 accumulate order
FP64_REL_LIMIT = 1e-12  # max abs difference relative to the row's l2 norm


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


def phase_build() -> dict:
    from repro_torch.kernels import _build

    _build.load()
    info = {"phase": "build", **_build.build_info()}
    # registers and spill bytes per kernel instantiation, from ptxas -v
    import re

    usage, name = {}, None
    for ln in _build.build_log("gbatc_kernels").splitlines():
        hit = re.search(r"gbatc_tile_kernelI([fd])Li(\d)ELi(\d)E", ln)
        if hit:
            name = "{}/{}/cmax{}".format(
                {"f": "f32", "d": "f64"}[hit.group(1)],
                ("project", "correct", "select")[int(hit.group(2))], hit.group(3))
        elif name and "spill" in ln:
            usage[name] = {"spill_bytes": sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", ln))}
        elif name and "registers" in ln:
            usage[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            name = None
    info["ptxas"] = usage
    emit(info)
    if not info["compiled"]:
        fail("kernels were not compiled from the checkout's sources in this run")
    return info


def time_ms(torch, fn, launches: int) -> float:
    """Median over ``launches`` single-launch CUDA-event timings. Operands
    are far larger than the 50 MB L2, so every launch finds it cold."""
    for _ in range(3):
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
    torch.cuda.synchronize()

    # -- main-path shapes: fp64 projection, fp32 select and replay --------
    rows = []
    n = S * NB * D

    def row(name, line, dtype, fn, plain, lib, rows_for_norm, nbytes, flops):
        got, want = fn(), plain()
        err = compare(torch, got, want, rows_for_norm, dtype)
        del got, want
        ms = time_ms(torch, fn, launches)
        plain_ms = time_ms(torch, plain, launches)
        library_ms = time_ms(torch, lib, launches) if lib is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gbatc_kernels.cu",
            "replaces": f"src/repro/kernels/gbatc_project.py:{line}",
            "launches": 0, "max_abs_err": max(err, ragged_err[name, dtype]),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "dtype": str(dtype).split(".")[-1], "shape": [S, NB, D],
            "bytes": nbytes, "flops": flops,
            "ragged_shapes_checked": RAGGED,
            "tolerance": ("max abs diff <= 1e-12 x row l2 norm"
                          if dtype == torch.float64 else "max abs diff <= 1e-5"),
        })

    x, c, u, rank, m = make_inputs(torch, S, NB, D, torch.float64, 1)
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
        (3 * n + S * D * D) * 4, 2 * n * D)
    del x, c, u, rank, m, ut
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "launches_timed": launches,
          "summary": [{k: r[k] for k in ("name", "dtype", "max_abs_err", "ms",
                                         "plain_ms", "library_ms", "bound_ms")}
                      for r in rows]})
    return rows


def phase_main_path(torch, args) -> dict:
    import numpy as np

    from repro_torch import codec
    from repro_torch.core import metrics
    from repro_torch.core.pipeline import GBATCCodec, PipelineConfig
    from repro_torch.data import s3d
    from repro_torch.kernels import gbatc_project as gk

    t0 = time.perf_counter()
    data = s3d.generate(s3d.S3DConfig(
        n_species=58, n_time=args.frames, height=args.height, width=args.width,
        seed=args.seed))["species"]
    gen_s = time.perf_counter() - t0
    cfg = PipelineConfig(latent=36, conv_channels=(32, 64), use_correction=True,
                         ae_steps=args.ae_steps, corr_steps=args.corr_steps,
                         seed=args.seed)
    target = 1e-3
    gk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    gb = GBATCCodec(cfg)
    t0 = time.perf_counter()
    blob, rep = gb.compress_report(data, target_nrmse=target)
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    stage_s = json.loads(json.dumps(gb.pipeline.timings))  # deep copy
    t0 = time.perf_counter()
    field = codec.decompress(blob)
    torch.cuda.synchronize()
    decompress_s = time.perf_counter() - t0
    counts = gk.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # host share of the decode: a fresh parse + entropy decode of every
    # stream, no network and no kernel (not part of the counted main path)
    t0 = time.perf_counter()
    codec.decode_artifact(blob)
    parse_s = time.perf_counter() - t0

    # -- the result is right, by the repo's own means ----------------------
    if field.shape != data.shape or field.dtype != np.float32:
        fail(f"decompressed field is {field.dtype}{field.shape}")
    if not np.isfinite(field).all():
        fail("decompressed field is not finite")
    nrmse = np.array([metrics.nrmse(data[s], field[s]) for s in range(58)])
    if not (nrmse <= target * (1 + 1e-3)).all():
        fail(f"per-species NRMSE bound missed: max {nrmse.max():.4e} > {target}")
    if not np.array_equal(field, rep.recon):
        fail("decompress(blob) differs from the compress report's recon "
             f"(max abs {np.abs(field - rep.recon).max():.3e})")
    if len(blob) != rep.bytes_breakdown["total"]:
        fail("len(blob) != byte breakdown total")
    for name, n in counts.items():
        if n < 1:
            fail(f"kernel {name} was never launched on the main path")

    # -- a second bound on the same fit reuses the prepared state ---------
    before = gk.launch_counts()
    t0 = time.perf_counter()
    blob2, rep2 = gb.compress_report(target_nrmse=1e-2)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    after = gk.launch_counts()
    if after["gbatc_project_batched"] != before["gbatc_project_batched"]:
        fail("second compress launched the projection again (prepare not reused)")
    if not (rep2.per_species_nrmse <= 1e-2 * (1 + 1e-3)).all():
        fail("second compress (1e-2) missed its bound")

    info = {
        "phase": "main_path", "shape": list(data.shape),
        "cut": {"frames": args.frames, "height": args.height,
                "width": args.width, "of_paper": [50, 640, 640],
                "ae_steps": args.ae_steps, "corr_steps": args.corr_steps},
        "widths": {"species": 58, "block": [4, 5, 4], "latent": 36,
                   "conv_channels": [32, 64], "correction": [232, 464, 232]},
        "generate_s": gen_s, "compress_s": compress_s,
        "decompress_s": decompress_s, "decode_artifact_s": parse_s,
        "second_compress_s": second_s,
        "timings_s": stage_s,
        "second_timings_s": {k: gb.pipeline.timings[k] for k in (
            "select", "encode", "report", "compress_total")},
        "max_nrmse": float(nrmse.max()), "target_nrmse": target,
        "compression_ratio": rep.compression_ratio, "blob_bytes": len(blob),
        "breakdown": rep.bytes_breakdown,
        "second_blob_bytes": len(blob2),
        "launches": counts, "peak_device_gb": peak_gb,
    }
    emit(info)
    return info


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="env,build,kernels,main_path")
    ap.add_argument("--launches", type=int, default=20,
                    help="timed launches per kernel (median reported)")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--ae-steps", type=int, default=200)
    ap.add_argument("--corr-steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    import repro_torch  # noqa: F401  (fails here when run outside a checkout)

    t_start = time.perf_counter()
    if "env" in phases:
        phase_env(torch)
    if "build" in phases:
        phase_build()
    rows = phase_kernels(torch, max(20, args.launches)) if "kernels" in phases else []
    if "main_path" in phases:
        info = phase_main_path(torch, args)
        for r in rows:
            r["launches"] = info["launches"][r["name"]]
    complete = all(p in phases for p in ("build", "kernels", "main_path"))
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
