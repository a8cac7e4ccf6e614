#!/usr/bin/env python3
"""Time ``flash_wide`` (flash attention past D = 256) at the wide-head
codec's chunk, (4096, 1, 232, 512) non-causal, alone and after other
kernels, and read how many of its CTAs an SM held, in one process on one
card.

Each variant is the checkout's ``kernels/csrc/flash_attention.cu`` with one
edit, built with the package's ``nvcc`` flags into ``build/flash_wide/`` and
called through its C entry points:

* ``checkout``: the source as it is (bh on grid x, query tiles on y, 256-dim
  slabs on z: the CTAs running at once hold different heads);
* ``carveout``: the launcher also asks for the largest shared-memory
  carveout (``cudaFuncAttributePreferredSharedMemoryCarveout``);
* ``heads_adjacent``: query tiles on x, slabs on y, bh on z, so that the 8
  CTAs of a head (4 query tiles x 2 slabs) run side by side and share its
  K and V in L2 (valid here: bh <= 65,535).

Each variant is also built with a probe that records, for every CTA, its SM
and its first and last ``%globaltimer``; from one probed launch the script
reports the most CTAs any SM held at once and the time-weighted mean it
held, beside ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.

Runs, in this order: every variant's first launches (before any other kernel
but the inputs' ``randn``); then after each predecessor (the variant itself,
an fp32 GEMM, SDPA, the plain version, the 3xTF32 and bf16 flash kernels,
``rwkv6_scan``) one launch of each variant timed with CUDA events, three
times, and one probed launch; then ``chip_smoke.phase_flash`` (the kernels
phase's flash checks, which time the package's build of the checkout in its
place in ``chip_smoke.py``); then each variant's median of 20 launches as
``chip_smoke.time_ms`` takes it. Every variant's output is held bitwise to
the checkout's and within ``FLASH_LIMIT`` of the plain version. Needs one
H100-class card:

    python3 tools/flash_wide_timing.py
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wk  # noqa: E402

SRC = open(os.path.join(ROOT, "src/repro_torch/kernels/csrc/flash_attention.cu")).read()
PROBE_N = 65536


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        sys.exit(f"tools/flash_wide_timing.py: the source no longer holds {old!r}")
    return src.replace(old, new)


ATTR = ("      flash_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WD_SMEM);\n"
        "  if (attr != cudaSuccess) return (int)attr;\n")
HEAD = "  const long long bh = blockIdx.x;\n  const int q0 = (q_tiles - 1 - yt) * WD_ROWS;\n"
LOOPS = ("  for (int zs = blockIdx.z; zs < slabs; zs += gridDim.z)\n"
         "    for (int yt = blockIdx.y; yt < q_tiles; yt += gridDim.y) {\n"
         "      if (zs != (int)blockIdx.z || yt != (int)blockIdx.y)\n")
GRID = "  dim3 grid((unsigned)bh, (unsigned)grid_y(q_tiles), (unsigned)grid_y(slabs));\n"
KERNEL = "template <typename T>\n__global__ void __launch_bounds__(WD_THREADS, 2)\nflash_wide("
OPEN = "           int q_tiles, int slabs) {\n"
CLOSE = "                         skip_below_window, yt, q_tiles, zs);\n    }\n}\n"


def carveout(src: str) -> str:
    return edit(src, ATTR, ATTR + (
        "  cudaFuncSetAttribute(flash_wide<T>, "
        "cudaFuncAttributePreferredSharedMemoryCarveout,\n"
        "                       (int)cudaSharedmemCarveoutMaxShared);\n"))


def heads_adjacent(src: str) -> str:
    src = edit(src, HEAD, HEAD.replace("blockIdx.x", "blockIdx.z"))
    src = edit(src, LOOPS, (
        "  for (int zs = blockIdx.y; zs < slabs; zs += gridDim.y)\n"
        "    for (int yt = blockIdx.x; yt < q_tiles; yt += gridDim.x) {\n"
        "      if (zs != (int)blockIdx.y || yt != (int)blockIdx.x)\n"))
    return edit(src, GRID, "  dim3 grid((unsigned)q_tiles, (unsigned)slabs, (unsigned)bh);\n")


def probed(src: str) -> str:
    src = edit(src, KERNEL, f"__device__ unsigned long long wd_probe[3 * {PROBE_N}];\n\n"
               + KERNEL)
    src = edit(src, OPEN, OPEN + (
        "  unsigned long long wd_t0;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(wd_t0));\n"))
    src = edit(src, CLOSE, CLOSE[:-2] + (
        "  if (threadIdx.x == 0) {\n"
        "    unsigned long long wd_t1;\n"
        "    unsigned wd_sm;\n"
        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(wd_t1));\n"
        "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(wd_sm));\n"
        "    const unsigned long long c = blockIdx.x + (unsigned long long)gridDim.x *\n"
        "        (blockIdx.y + (unsigned long long)gridDim.y * blockIdx.z);\n"
        f"    if (c < {PROBE_N}) {{\n"
        "      wd_probe[3 * c] = wd_sm;\n"
        "      wd_probe[3 * c + 1] = wd_t0;\n"
        "      wd_probe[3 * c + 2] = wd_t1;\n"
        "    }\n"
        "  }\n"
        "}\n"))
    return src + (
        "\nextern \"C\" int wd_probe_clear() {\n"
        "  void* p;\n"
        "  cudaError_t e = cudaGetSymbolAddress(&p, wd_probe);\n"
        "  if (e != cudaSuccess) return (int)e;\n"
        "  return (int)cudaMemset(p, 0, sizeof(wd_probe));\n"
        "}\n"
        "extern \"C\" int wd_probe_read(unsigned long long* host) {\n"
        "  return (int)cudaMemcpyFromSymbol(host, wd_probe, sizeof(wd_probe));\n"
        "}\n"
        "extern \"C\" int wd_occupancy(int* f32, int* b16) {\n"
        "  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
        "      f32, flash_wide<float>, WD_THREADS, WD_SMEM);\n"
        "  if (e != cudaSuccess) return (int)e;\n"
        "  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
        "      b16, flash_wide<bf16>, WD_THREADS, WD_SMEM);\n"
        "}\n")


VARIANTS = {"checkout": SRC, "carveout": carveout(SRC), "heads_adjacent": heads_adjacent(SRC)}
B, H, T, D = cs.FLASH_WIDE_PATH


def build() -> dict:
    """Starts every variant's nvcc (plain and probed), then the package's
    build; returns {name: (CDLL, probed CDLL, ptxas of flash_wide)}."""
    out_dir = os.path.join(ROOT, "build", "flash_wide")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in VARIANTS.items():
        for tag, text in (("", src), ("_probe", probed(src))):
            path = os.path.join(out_dir, f"{name}{tag}.cu")
            with open(path, "w") as f:
                f.write(text)
            lib = os.path.join(out_dir, f"lib{name}{tag}.so")
            procs[name + tag] = (lib, subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.load()
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {key}:\n{log[-3000:]}")
        usage, cur = [], False
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                cur = "flash_wide" in ln
            elif cur and ("spill" in ln or "Used" in ln):
                usage.append(ln.strip()[-90:])
        libs[key] = (ctypes.CDLL(lib), usage)
    out = {}
    for name in VARIANTS:
        plain, usage = libs[name]
        probe, _ = libs[name + "_probe"]
        for lib in (plain, probe):
            for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                               + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        out[name] = (plain, probe)
        print(json.dumps({"variant": name, "ptxas_flash_wide": usage}), flush=True)
    return out


def launch(lib, q, k, v):
    o = torch.empty_like(q)
    fn = lib.flash_attention_f32 if q.dtype == torch.float32 else lib.flash_attention_bf16
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B * H, T, T, D, 0, 0,
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if rc:
        sys.exit(f"flash_wide failed to launch: error {rc}")
    return o


def event_ms(fn) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def residency(probe, qkv) -> dict:
    """One probed launch: the most CTAs an SM held at once (the median and
    the largest over SMs) and the time-weighted mean an SM held."""
    if probe.wd_probe_clear():
        sys.exit("wd_probe_clear failed")
    launch(probe, *qkv)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (3 * PROBE_N))()
    if probe.wd_probe_read(buf):
        sys.exit("wd_probe_read failed")
    rec = torch.tensor(list(buf), dtype=torch.float64).view(PROBE_N, 3)
    rec = rec[rec[:, 2] > 0]
    sm, t0, t1 = rec[:, 0].long(), rec[:, 1], rec[:, 2]
    span = float(t1.max() - t0.min())
    peaks = []
    for s in sm.unique().tolist():
        mine = sm == s
        ev = sorted([(float(x), 1) for x in t0[mine]] + [(float(x), -1) for x in t1[mine]],
                    key=lambda e: (e[0], e[1]))
        live = peak = 0
        for _, d in ev:
            live += d
            peak = max(peak, live)
        peaks.append(peak)
    peaks.sort()
    return {"ctas": int(rec.shape[0]), "sms": len(peaks),
            "max_resident_median": peaks[len(peaks) // 2], "max_resident_max": peaks[-1],
            "mean_resident": float((t1 - t0).sum()) / (span * len(peaks)),
            "span_ms": span / 1e6}


def clocks() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                          "temperature.gpu", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/flash_wide_timing.py: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build()
    print(cs.gpu_line(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(950)
    qkv32 = [torch.randn(B, H, T, D, generator=g, device="cuda") for _ in range(3)]
    qkv16 = [x.to(torch.bfloat16) for x in qkv32]
    first = {}
    for name, (plain, _) in libs.items():
        first[name] = [event_ms(lambda: launch(plain, *qkv32)) for _ in range(3)]
    print(json.dumps({"run": "first launches, fp32", "ms": first, "clocks": clocks()}),
          flush=True)
    ref32 = kref.flash_attention_ref(*qkv32, causal=False)
    ref16 = kref.flash_attention_ref(*qkv16, causal=False).float()
    base = {dt: launch(libs["checkout"][0], *x) for dt, x in (("f32", qkv32), ("bf16", qkv16))}
    bits = {}
    for name, (plain, _) in libs.items():
        for dt, x, want in (("f32", qkv32, ref32), ("bf16", qkv16, ref16)):
            o = launch(plain, *x)
            bits[f"{name}/{dt}"] = {"bits_of_checkout": bool(torch.equal(o, base[dt])),
                                    "max_abs_err": float((o.float() - want).abs().max())}
            limit = cs.FLASH_LIMIT["float32" if dt == "f32" else "bfloat16"]
            if (not bits[f"{name}/{dt}"]["bits_of_checkout"]
                    or bits[f"{name}/{dt}"]["max_abs_err"] > limit):
                sys.exit(f"variant {name} ({dt}): {bits[f'{name}/{dt}']}")
    print(json.dumps({"run": "bits", "variants": bits}), flush=True)
    del ref32, ref16, base
    a = torch.randn(4096, 4096, generator=g, device="cuda")
    g3 = [torch.randn(2, 8, 512, 256, generator=g, device="cuda") for _ in range(3)]
    gb = [torch.randn(2, 8, 512, 128, generator=g, device="cuda").to(torch.bfloat16)
          for _ in range(3)]
    rw = [torch.randn(2, 256, 8, 64, generator=g, device="cuda") for _ in range(3)]
    rw_w = torch.rand(2, 256, 8, 64, generator=g, device="cuda") * 0.5 + 0.4
    rw_u = torch.randn(8, 64, generator=g, device="cuda")
    preds = {
        "itself": None,
        "sgemm_4096": lambda: a @ a,
        "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(*qkv32),
        "plain": lambda: kref.flash_attention_ref(*qkv32, causal=False),
        "flash_3xtf32_d256": lambda: fk.flash_attention(*g3, causal=True),
        "flash_bf16_d128": lambda: fk.flash_attention(*gb, causal=True),
        "rwkv6_scan": lambda: wk.rwkv6_scan(rw[0], rw[1], rw[2], rw_w, rw_u),
    }
    for pname, pred in preds.items():
        row = {"run": f"after {pname}", "fp32": {}}
        for name, (plain, probe) in libs.items():
            ms = []
            for _ in range(3):
                if pred is not None:
                    pred()
                torch.cuda.synchronize()
                ms.append(event_ms(lambda: launch(plain, *qkv32)))
            if pred is not None:
                pred()
            torch.cuda.synchronize()
            row["fp32"][name] = {"ms": ms, "residency": residency(probe, qkv32)}
        row["clocks"] = clocks()
        print(json.dumps(row), flush=True)
    del a, g3, gb, rw, rw_w, rw_u
    torch.cuda.empty_cache()
    # the kernels phase's flash checks: the package's build of the checkout,
    # timed where chip_smoke.py times it
    flash_row = cs.phase_flash(torch, 20)
    placed = {dn: flash_row["wide_heads"][dn]["ms"] for dn in ("float32", "bfloat16")}
    after = {}
    for name, (plain, probe) in libs.items():
        after[name] = {
            "fp32_ms": cs.time_ms(torch, lambda: launch(plain, *qkv32), 20),
            "bf16_ms": cs.time_ms(torch, lambda: launch(plain, *qkv16), 20),
            "fp32_residency": residency(probe, qkv32),
            "bf16_residency": residency(probe, qkv16)}
    # after the probed launches of both dtypes, which set the launchers'
    # shared-memory attribute that the occupancy query reads
    occ32, occ16 = ctypes.c_int(), ctypes.c_int()
    if libs["checkout"][1].wd_occupancy(ctypes.byref(occ32), ctypes.byref(occ16)):
        sys.exit("wd_occupancy failed")
    print(json.dumps({"run": "in chip_smoke's kernels phase, then each variant's median "
                      "of 20", "phase_flash_wide_heads_ms": placed, "variants": after,
                      "occupancy_api_ctas_per_sm": {"f32": occ32.value, "bf16": occ16.value},
                      "clocks": clocks()}), flush=True)


if __name__ == "__main__":
    main()
