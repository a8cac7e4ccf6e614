#!/usr/bin/env python3
"""Time the fp32 3xTF32 flash kernel (``flash_f32_3xtf32``) against the
design choices it did not take, in one process on one card.

Each variant is the checkout's ``kernels/csrc/flash_attention.cu`` with one
edit, built with the package's ``nvcc`` flags into ``build/flash_variants/``
and called through its C entry point ``flash_attention_f32`` at the fp32 LM
shapes of ``chip_smoke.py`` (``LM_FLASH_SHAPES``):

* ``checkout``: the source as it is;
* ``lo_rna``: lo rounded to tf32 as ``cvt.rna.tf32`` does (an integer add),
  not left for the tensor cores to round toward zero;
* ``mt1``: one 16-row m-tile a warp (64-row CTAs; 64 keys a tile to
  DP = 80, 32 above);
* ``kn32``: 32-key tiles at DP = 128 (one CTA an SM).

Prints each build's registers and spills, then one JSON line a shape: each
variant's max abs difference from the plain version, whether its bits are
the checkout's, and its median of 20 CUDA-event launches, taken twice in
turns (forward order, then reverse). Needs one H100-class card:

    python3 tools/flash_f32_variants.py [VARIANT ...]
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
from repro_torch.kernels import ref as kref  # noqa: E402

SRC = open(os.path.join(ROOT, "src/repro_torch/kernels/csrc/flash_attention.cu")).read()


def edit(old: str, new: str) -> str:
    if SRC.count(old) != 1:
        sys.exit(f"tools/flash_f32_variants.py: the source no longer holds {old!r}")
    return SRC.replace(old, new)


LO = "  lo = __float_as_uint(x - __uint_as_float(hi & TF32_MASK));"
MT = "__host__ __device__ constexpr int tf_mtiles() { return DP <= 128 ? 2 : 1; }"
KN = "  return DP <= 64 ? 64 : DP <= 80 ? 32 : DP <= 128 ? 16 : 32;"
VARIANTS = {
    "checkout": SRC,
    "lo_rna": edit(LO, LO[:-1] + " + TF32_HALF_ULP;"),
    "mt1": edit(MT, MT.replace("DP <= 128 ? 2 : 1", "1")).replace(
        KN, "  return DP <= 80 ? 64 : 32;"),
    "kn32": edit(KN, "  return DP <= 64 ? 64 : 32;"),
}


def build(names) -> dict:
    out_dir = os.path.join(ROOT, "build", "flash_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(VARIANTS[name])
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        usage, cur = {}, None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                cur = None
                if "flash_f32_3xtf32ILi" in ln:
                    cur = "dp" + ln.split("flash_f32_3xtf32ILi", 1)[1].split("E", 1)[0]
            elif cur and ("spill" in ln or "Used" in ln):
                usage[cur] = (usage.get(cur, "") + " " + ln.strip()[-80:]).strip()
        print(json.dumps({"variant": name, "ptxas": usage}), flush=True)
        fn = ctypes.CDLL(lib).flash_attention_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fns[name] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/flash_f32_variants.py: needs a CUDA device")
    names = ["checkout"] + [n for n in (sys.argv[1:] or VARIANTS) if n != "checkout"]
    fns = build(names)
    print(cs.gpu_line(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(700)
    for shape, (b, h, tq, tk, d, causal, window) in cs.LM_FLASH_SHAPES.items():
        q = torch.randn(b, h, tq, d, generator=g, device="cuda")
        k, v = (torch.randn(b, h, tk, d, generator=g, device="cuda") for _ in range(2))
        want = kref.flash_attention_ref(q, k, v, causal=causal, window=window)

        def call(name):
            o = torch.empty_like(q)
            rc = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h,
                           tq, tk, d, int(causal), int(window), 1.0 / math.sqrt(d),
                           torch.cuda.current_stream().cuda_stream)
            if rc:
                sys.exit(f"variant {name} failed to launch at {shape}: error {rc}")
            return o

        row = {"shape": shape}
        base = call("checkout")
        for name in names:
            o = call(name)
            row[name] = {"max_abs_err": float((o - want).abs().max()),
                         "bits_of_checkout": bool(torch.equal(o, base)), "ms": []}
        for name in names + names[::-1]:
            row[name]["ms"].append(cs.time_ms(torch, lambda: call(name), 20))
        print(json.dumps(row), flush=True)
        del q, k, v, want, base
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
