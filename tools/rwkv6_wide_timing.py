#!/usr/bin/env python3
"""Check and time ``rwkv6_scan`` past N = 64 against an earlier build of its
source, in one process on one card.

Builds ``kernels/csrc/rwkv6_scan.cu`` of the checkout, an earlier copy of
it (``--parent``) and any further copies (``--variant NAME=PATH``) with the
package's ``nvcc`` flags into ``build/rwkv6_wide_timing/<name>/``
(``flash_wide_timing.build``, all at once) and calls each through its C
entry points:

* every build is held to the plain version (``kernels/ref.rwkv6_scan_ref``)
  at every ``chip_smoke.RWKV_WIDE`` shape in fp32 and bf16, with a random
  s0, within ``chip_smoke.RWKV_LIMIT`` of max(1, max |plain|) (plus one
  bf16 ulp of it in bf16; S_T within the limit of its own largest value),
  and to the same bits twice;
* every build is timed at ``chip_smoke.RWKV_WIDE_PATH`` = (8, 1024, 32, 128)
  and ``RWKV_WIDER_PATH`` = (2, 1024, 8, 512), both dtypes, as
  ``chip_smoke.time_ms`` times a kernel (the median of 20 single CUDA-event
  launches), in turns: the builds in order (parent, checkout, variants),
  then in reverse; the same-call ratio parent / checkout is the speed-up;
  ``device_ms`` is each build's mean of 200 back-to-back launches
  (``chip_smoke.device_ms``: the device alone, without the host's call).
  Each line gives the bound (the larger of the bytes at 3.35 TB/s and the
  chunked form's products at 165 TFLOP/s, ``chip_smoke.rwkv_chunk_flops``)
  and the step form's FFMA bound;
* ``--digests`` prints the checkout's ``chip_smoke.rwkv_wide_digests``, the
  values ``chip_smoke.RWKV_WIDE_SHA256`` pins; ``--sass`` writes the
  checkout's SASS of ``rwkv6_chunked`` to ``chiprun_out/rwkv6_chunked_sass.txt``
  with each kernel's instructions, local loads / stores and HMMAs;
  ``--probes`` also times ``PROBES``, copies of the checkout with parts of
  a piece taken out (the copies, the prep, A, the products), and the phase
  alone (``*_only``), whose outputs are wrong by design.

The ``build`` line lists each build's ``ptxas`` registers and spill bytes
of its kernels. Needs one H100-class card. The card's machine may lack git,
so take the parent's source out first::

    mkdir -p build/rwkv6_wide_timing/parent
    git show <commit>:src/repro_torch/kernels/csrc/rwkv6_scan.cu \\
        > build/rwkv6_wide_timing/parent/rwkv6_scan.cu
    python3 tools/rwkv6_wide_timing.py --parent build/rwkv6_wide_timing/parent/rwkv6_scan.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
from flash_wide_timing import build, sass  # noqa: E402  (puts the checkout on sys.path)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

CHECKOUT = os.path.join(ROOT, "src/repro_torch/kernels/csrc/rwkv6_scan.cu")
OUT = os.path.join(ROOT, "build", "rwkv6_wide_timing")
P, I = ctypes.c_void_p, ctypes.c_int
# --probes: copies of the checkout with a part of rwkv6_chunked's piece
# taken out (their outputs are wrong; they are timed only): the next
# panel's copies, the prep, A's pairs and bonus, the products
_NO_COPY = [("      if (n_piece + 1 < nchunks * npan) {",
              "      if (n_piece + 1 < nchunks * npan && n < 0) {")]
_NO_PREP = [("      ck_prep<T, NP>(smem, u, hi, c, p, slot, t_len, n);",
             "      if (n < 0) ck_prep<T, NP>(smem, u, hi, c, p, slot, t_len, n);")]
_NO_A = [("        for (int m = 0; m < KP / (4 * CK_BPARTS); ++m) {",
          "        for (int m = 0; m < (n < 0 ? KP / (4 * CK_BPARTS) : 0); ++m) {"),
         ("        for (int m = 0; m < KP / (4 * CK_DPARTS); ++m) {",
          "        for (int m = 0; m < (n < 0 ? KP / (4 * CK_DPARTS) : 0); ++m) {")]
_NO_STATE = [("      for (int kk = 0; kk < MT; ++kk) {",
              "      for (int kk = 0; kk < (n < 0 ? MT : 0); ++kk) {")]
_NO_UPDATE = [("      for (int f = 0; f < FP; ++f) {\n        const int fi",
               "      for (int f = 0; f < (n < 0 ? FP : 0); ++f) {\n        const int fi")]
_NO_MMA = _NO_STATE + _NO_UPDATE
PROBES = {"no_copy": _NO_COPY, "no_prep": _NO_PREP, "no_a": _NO_A, "no_mma": _NO_MMA,
          "mma_only": _NO_COPY + _NO_PREP + _NO_A,
          "state_only": _NO_COPY + _NO_PREP + _NO_A + _NO_UPDATE,
          "update_only": _NO_COPY + _NO_PREP + _NO_A + _NO_STATE,
          "frame_only": _NO_COPY + _NO_PREP + _NO_A + _NO_MMA,
          "a_only": _NO_COPY + _NO_PREP + _NO_MMA,
          "prep_only": _NO_COPY + _NO_A + _NO_MMA,
          "copy_only": _NO_PREP + _NO_A + _NO_MMA}


def probe_sources() -> dict:
    """{probe name: path of the checkout's source with its edits}."""
    text = open(CHECKOUT).read()
    out = {}
    for name, edits in PROBES.items():
        src = text
        for old, new in edits:
            if old not in src:
                sys.exit(f"probe {name}: the checkout's source has no {old!r}")
            src = src.replace(old, new)
        path = os.path.join(OUT, "probes", f"{name}.cu")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(src)
        out[name] = path
    return out


def declare(cdll) -> dict:
    fns = {}
    for dt, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        fn = getattr(cdll, f"rwkv6_scan_{suffix}")
        fn.restype = I
        fn.argtypes = [P] * 8 + [I] * 4 + [P]
        fns[dt] = fn
    return fns


def scan(fns, r, k, v, w, u, s0=None):
    """One launch on the wrapper's operands: (out, S_T)."""
    b, t, h, n = r.shape
    out = torch.empty_like(r)
    s_last = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    rc = fns[r.dtype](r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                      0 if s0 is None else s0.data_ptr(), out.data_ptr(), s_last.data_ptr(),
                      b, t, h, n, torch.cuda.current_stream().cuda_stream)
    if rc:
        sys.exit(f"rwkv6_scan ({r.dtype}, {(b, t, h, n)}) failed to launch: error {rc}")
    return out, s_last


def inputs(b, t, h, n, dtype, g):
    """chip_smoke's kernels-phase operands: unit normals, w = sigmoid(3 x)
    clamped to [1e-6, 1 - 1e-6], u at half scale, a random s0."""
    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    r, k, v = (randn(b, t, h, n).to(dtype) for _ in range(3))
    w = torch.sigmoid(3.0 * randn(b, t, h, n)).clamp(1e-6, 1 - 1e-6).to(dtype)
    return r, k, v, w, (0.5 * randn(h, n)).to(dtype), randn(b, h, n, n)


def check(fns) -> tuple[dict, list]:
    """Every RWKV_WIDE shape, both dtypes: the plain version and the same
    bits twice. Returns ({case: (out error, S_T error)}, the failures)."""
    errs, bad = {}, []
    g = torch.Generator(device="cuda").manual_seed(970)
    for shape in cs.RWKV_WIDE:
        for dtype in (torch.float32, torch.bfloat16):
            args = inputs(*shape, dtype, g)
            out, s_last = scan(fns, *args)
            want, want_last = kref.rwkv6_scan_ref(*args)
            top = max(1.0, float(want.float().abs().max()))
            limit = cs.RWKV_LIMIT * top + (cs.BF16_ULP * top if dtype == torch.bfloat16 else 0.0)
            e = float((out.float() - want.float()).abs().max())
            e_s = float((s_last - want_last).abs().max())
            key = f"{list(shape)}/{str(dtype)[6:]}"
            errs[key] = (e / top, e_s)
            finite = bool(torch.isfinite(out).all() and torch.isfinite(s_last).all())
            if not finite or e > limit or e_s > cs.RWKV_LIMIT * max(
                    1.0, float(want_last.abs().max())):
                bad.append([key, e, e_s, finite])
            again = scan(fns, *args)
            if not (torch.equal(out, again[0]) and torch.equal(s_last, again[1])):
                bad.append([key, "two launches differ"])
            del args, out, s_last, want, want_last, again
        torch.cuda.empty_cache()
    return errs, bad


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an earlier rwkv6_scan.cu")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=PATH",
                    help="a further source (an edit of the checkout's) to time")
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--digests", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--probes", action="store_true",
                    help="also time PROBES, the checkout with parts of its piece taken out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/rwkv6_wide_timing.py: needs a CUDA device")
    sources = {"parent": args.parent, "checkout": CHECKOUT}
    sources.update(v.split("=", 1) for v in args.variant)
    if args.probes:
        sources.update(probe_sources())
    libs = build(sources, stem="rwkv6_scan", kernels="rwkv6", out=OUT)
    print(json.dumps({"build": {n: u for n, (_, u) in libs.items()}}), flush=True)
    if args.sass:
        print(json.dumps({"sass": sass(os.path.join(OUT, "checkout", "librwkv6_scan.so"),
                                       kernels="rwkv6_chunked", name="rwkv6_chunked")}),
              flush=True)
    print(cs.gpu_line(), flush=True)
    fns = {name: declare(cdll) for name, (cdll, _) in libs.items()}
    failed = False
    # the probes, wrong by design, are only timed
    for name in ("parent", "checkout", *(v.split("=", 1)[0] for v in args.variant)):
        errs, bad = check(fns[name])
        print(json.dumps({"checks": name, "shapes": cs.RWKV_WIDE,
                          "relative_out_and_abs_state_errors": errs, "failures": bad}),
              flush=True)
        failed |= bool(bad)
    if args.digests:
        print(json.dumps({"digests": cs.rwkv_wide_digests(
            torch, lambda *a: scan(fns["checkout"], *a))}), flush=True)
    order = list(fns) + list(fns)[::-1]
    g = torch.Generator(device="cuda").manual_seed(971)
    for path in (cs.RWKV_WIDE_PATH, cs.RWKV_WIDER_PATH):
        b, t, h, n = path
        for dtype in (torch.float32, torch.bfloat16):
            ops = inputs(b, t, h, n, dtype, g)
            tokens = b * t * h
            nbytes = (5 * tokens * n + h * n) * dtype.itemsize + 2 * b * h * n * n * 4
            flops = cs.rwkv_chunk_flops(b, t, h, n)
            row = {"shape": list(path), "dtype": str(dtype)[6:], "ms": {},
                   "bound_ms": max(nbytes / cs.HBM_BYTES_PER_S,
                                   flops / cs.PEAK_FLOPS["float32_3xtf32"]) * 1e3,
                   "bound_by": ("bytes" if nbytes / cs.HBM_BYTES_PER_S
                                >= flops / cs.PEAK_FLOPS["float32_3xtf32"] else "operations"),
                   "bound_ffma_ms": 5 * tokens * n * n / cs.PEAK_FLOPS["float32"] * 1e3}
            for name in order:
                row["ms"].setdefault(name, []).append(cs.time_ms(
                    torch, lambda: scan(fns[name], *ops), args.launches))
            row["device_ms"] = {name: cs.device_ms(torch, lambda: scan(fns[name], *ops))
                                for name in fns}
            mean = {name: sum(v) / len(v) for name, v in row["ms"].items()}
            row["parent_over_checkout"] = mean["parent"] / mean["checkout"]
            row["bound_share"] = row["bound_ms"] / mean["checkout"]
            print(json.dumps(row), flush=True)
            del ops
            torch.cuda.empty_cache()
    print(cs.gpu_line(), flush=True)
    if failed:
        sys.exit("tools/rwkv6_wide_timing.py: a build missed a check (see its line)")


if __name__ == "__main__":
    main()
