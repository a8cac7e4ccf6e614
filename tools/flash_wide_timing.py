#!/usr/bin/env python3
"""Time flash attention past D = 256 against an earlier build of its
source, in one process on one card.

Builds ``kernels/csrc/flash_attention.cu`` of the checkout, an earlier
copy of the same file (``--parent``) and any further variants
(``--variant NAME=PATH``: a copy of the source with an edit), each with the
package's ``nvcc`` flags into ``build/flash_wide_timing/<name>/``, all at
once, and calls each through its C entry points. At the wide-head codec's
two flash shapes, its 4096-block decode chunk ``chip_smoke.FLASH_WIDE_PATH``
= (4096, 1, 232, 512) and its 512-block encode batch (512, 1, 232, 512),
both non-causal, in fp32 and bf16:

* every build's output is held to the plain version
  (``kernels/ref.flash_attention_ref``) within ``chip_smoke.FLASH_LIMIT``
  and, in bf16, ``chip_smoke.bf16_ulp_ratio`` <= 1; the checkout's build is
  held bitwise to the package's own launch;
* each build is timed as ``chip_smoke.time_ms`` times a kernel (the median
  of 20 single CUDA-event launches) in turns, parent, checkout, variants,
  then the same in reverse, beside ``scaled_dot_product_attention`` on the
  same inputs; the same-call ratio parent / checkout is the speed-up.

The ``build`` line lists each build's ``ptxas`` registers and spill bytes
of its wide kernels; ``--sass`` also writes the checkout's SASS of them to
``chiprun_out/flash_wide_sass.txt`` with a count of local-memory loads and
stores (spills) and tensor-core MMAs a kernel. Needs one H100-class card.
The parent's source comes from git, which the card's machine may lack, so
take it out first::

    mkdir -p build/flash_wide_timing/parent
    git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu \\
        > build/flash_wide_timing/parent/flash_attention.cu
    python3 tools/flash_wide_timing.py --parent build/flash_wide_timing/parent/flash_attention.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
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

CHECKOUT = os.path.join(ROOT, "src/repro_torch/kernels/csrc/flash_attention.cu")
OUT = os.path.join(ROOT, "build", "flash_wide_timing")
B, H, T, D = cs.FLASH_WIDE_PATH
SHAPES = {"decode_4096": (B, H, T, D), "encode_512": (512, H, T, D)}


def build(sources: dict, stem: str = "flash_attention", kernels: str = "flash_wide",
          out: str = OUT) -> dict:
    """{name: path of a copy of ``csrc/<stem>.cu``} -> {name: (CDLL, ptxas
    usage of its kernels whose names hold ``kernels``)}, each built with the
    package's nvcc flags into ``<out>/<name>/``; every nvcc runs at once."""
    procs = {}
    for name, src in sources.items():
        out_dir = os.path.join(out, name)
        os.makedirs(out_dir, exist_ok=True)
        lib = os.path.join(out_dir, f"lib{stem}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            errors = "\n".join(ln for ln in log.splitlines() if "error" in ln)
            sys.exit(f"nvcc failed on {name}:\n{errors[:6000]}\n{log[-1500:]}")
        usage, cur = {}, None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                cur = m.group(1) if kernels in m.group(1) else None
            elif cur and ("spill" in ln or "Used" in ln):
                usage.setdefault(cur, []).append(ln.strip()[-100:])
        libs[name] = (ctypes.CDLL(lib), usage)
    return libs


def declare_flash(libs: dict) -> dict:
    """The C signatures of ``build``'s flash libraries; returns ``libs``."""
    for cdll, _ in libs.values():
        for fn in (cdll.flash_attention_f32, cdll.flash_attention_bf16):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    return libs


def launch(lib, q, k, v):
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    fn = lib.flash_attention_f32 if q.dtype == torch.float32 else lib.flash_attention_bf16
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, t, k.shape[2], d,
            0, 0, 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if rc:
        sys.exit(f"flash_attention failed to launch: error {rc}")
    return o


def sass(lib_path: str) -> dict:
    """The checkout's SASS of its wide kernels into chiprun_out/, and per
    kernel its instructions, local loads / stores and HMMAs."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300).stdout
    funcs = [f for f in re.split(r"\n\s+Function : ", text)[1:] if "flash_wide" in f[:200]]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "flash_wide_sass.txt"), "w") as f:
        f.write("\n\n".join(funcs))
    out = {}
    for func in funcs:
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)
        out[func.split("\n", 1)[0].strip()] = {
            "instructions": len(ops), "ldl": sum(o.startswith("LDL") for o in ops),
            "stl": sum(o.startswith("STL") for o in ops),
            "hmma": sum(o.startswith("HMMA") for o in ops),
            "ffma": sum(o.startswith("FFMA") for o in ops),
            "bar": sum(o.startswith("BAR") for o in ops)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an earlier flash_attention.cu")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=PATH",
                    help="a further source to time beside the two")
    ap.add_argument("--sass", action="store_true", help="dump the checkout's wide kernels")
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/flash_wide_timing.py: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = {"parent": args.parent, "checkout": CHECKOUT}
    for v in args.variant:
        name, path = v.split("=", 1)
        sources[name] = path
    libs = declare_flash(build(sources))
    print(json.dumps({"build": {n: u for n, (_, u) in libs.items()}}), flush=True)
    if args.sass:
        print(json.dumps({"sass": sass(os.path.join(OUT, "checkout",
                                                     "libflash_attention.so"))}), flush=True)
    print(cs.gpu_line(), flush=True)
    order = list(libs)
    g = torch.Generator(device="cuda").manual_seed(950)
    for shape_name, (b, h, t, d) in SHAPES.items():
        qkv32 = [torch.randn(b, h, t, d, generator=g, device="cuda") for _ in range(3)]
        for dn, qkv in (("float32", qkv32),
                        ("bfloat16", [x.to(torch.bfloat16) for x in qkv32])):
            want = kref.flash_attention_ref(*qkv, causal=False).float()
            row = {"shape": shape_name, "dims": [b, h, t, d], "dtype": dn, "builds": {}}
            for name in order:
                o = launch(libs[name][0], *qkv).float()
                diff = (o - want).abs()
                err = float(diff.max())
                ratio = cs.bf16_ulp_ratio(diff, want) if dn == "bfloat16" else 0.0
                if err > cs.FLASH_LIMIT[dn] or ratio > 1.0:
                    sys.exit(f"{name} at {shape_name} {dn}: max abs {err:.3e}, "
                             f"ulp ratio {ratio:.3f}")
                row["builds"][name] = {"max_abs_err": err, "bf16_ulp_ratio": ratio, "ms": []}
                del o, diff
            if not torch.equal(launch(libs["checkout"][0], *qkv),
                               fk.flash_attention(*qkv, causal=False)):
                sys.exit(f"the checkout's build differs from the package's at {shape_name} {dn}")
            del want
            for name in order + order[::-1]:
                row["builds"][name]["ms"].append(cs.time_ms(
                    torch, lambda: launch(libs[name][0], *qkv), args.launches))
            row["sdpa_ms"] = cs.time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(*qkv),
                args.launches)
            for name in order:
                row["builds"][name]["ms_mean"] = sum(row["builds"][name]["ms"]) / 2
            mine = row["builds"]["checkout"]["ms_mean"]
            row["parent_over_checkout"] = row["builds"]["parent"]["ms_mean"] / mine
            row["checkout_over_sdpa"] = mine / row["sdpa_ms"]
            print(json.dumps(row), flush=True)
            del qkv
        del qkv32
        torch.cuda.empty_cache()
    print(cs.gpu_line(), flush=True)


if __name__ == "__main__":
    main()
