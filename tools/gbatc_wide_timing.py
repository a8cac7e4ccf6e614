#!/usr/bin/env python3
"""Check and time the GBATC routes past D = 128 against an earlier build of
their source, in one process on one card.

Builds ``kernels/csrc/gbatc_kernels.cu`` of the checkout, an earlier copy of
it (``--parent``) and any further copies (``--variant NAME=PATH``; with
``--probes``, ``PROBES``: the checkout with the copies, the split or the
MMAs taken out) with the package's ``nvcc`` flags into
``build/gbatc_wide_timing/<name>/`` (``flash_wide_timing.build``, all at
once) and calls each through its C entry points:

* the parent's and the checkout's every route (fp32 and fp64 project,
  correct and select, and the masked 2D correct) at every
  ``chip_smoke.WIDE`` and ``ANY_D`` shape and ``GBATC_2D_ANY_D``'s first
  two is held to its plain version (``chip_smoke.FP32_LIMIT``,
  ``FP64_REL_LIMIT``); select is held bitwise to correct on ``where(rank <
  m, c, 0)`` in both dtypes, and each route to the same bits twice; the
  line gives each route's largest error, by shape, and the fp32 kernel's
  and plain version's largest difference from the product in fp64;
* at (58, 1600, 512), (1, 65536, 256) and the 2D (92800, 512) every build
  is timed as ``chip_smoke.time_ms`` times a kernel, in turns (the builds in
  order, then in reverse), beside the route's one-call library yardstick
  (``bmm``, ``baddbmm``, ``mm``; none for select and the masked 2D
  correct); the same-call ratio parent / checkout is the speed-up;
* ``--digests`` prints the checkout's sha256 of every route at every
  ``WIDE`` and ``ANY_D`` shape on ``chip_smoke.wide_digest_operands``, the
  values ``chip_smoke.WIDE_SHA256`` / ``ANY_D_SHA256`` pin.

The ``build`` line lists each build's ``ptxas`` registers and spill bytes
of its kernels past D = 128. Needs one H100-class card. The card's machine
may lack git, so take the parent's source out first::

    mkdir -p build/gbatc_wide_timing/parent
    git show <commit>:src/repro_torch/kernels/csrc/gbatc_kernels.cu \\
        > build/gbatc_wide_timing/parent/gbatc_kernels.cu
    python3 tools/gbatc_wide_timing.py --parent build/gbatc_wide_timing/parent/gbatc_kernels.cu --probes
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
from flash_wide_timing import build  # noqa: E402  (puts the checkout on sys.path)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

CHECKOUT = os.path.join(ROOT, "src/repro_torch/kernels/csrc/gbatc_kernels.cu")
OUT = os.path.join(ROOT, "build", "gbatc_wide_timing")
# --probes: copies of the checkout with a part of both wide kernels taken
# out (their outputs are wrong; they are timed only): the producer warps'
# copies, the fp32 producers' split, the MMA warps' MMAs
_NO_COPY = [("      if (v + STAGES - 1 < steps) issue();\n      cp_async_commit();\n"
             "      if (++p == panels) p = 0, ++t;",
             "      if (v + STAGES - 1 < steps && d < 0) issue();\n      cp_async_commit();\n"
             "      if (++p == panels) p = 0, ++t;"),
            ("        if (v >= 1) mbar_wait_or_trap(empty + (v - 1) % STAGES, ((v - 1) / STAGES) & 1);\n"
             "        issue();",
             "        if (v >= 1) mbar_wait_or_trap(empty + (v - 1) % STAGES, ((v - 1) / STAGES) & 1);\n"
             "        if (d < 0) issue();")]
_NO_SPLIT = [("      for (int r2 = 0; r2 < TM * 2 / P; ++r2) {",
              "      for (int r2 = 0; r2 < (d < 0 ? TM * 2 / P : 0); ++r2) {"),
             ("      for (int r = 0; r < WT_SLAB * KP / 4 / P; ++r) {\n        const int i = pt + r * P;\n"
              "        if (PROJECT) {\n          // B[k]",
              "      for (int r = 0; r < (d < 0 ? WT_SLAB * KP / 4 / P : 0); ++r) {\n"
              "        const int i = pt + r * P;\n        if (PROJECT) {\n          // B[k]")]
_NO_MMA = [("    if (nf_w == 8) mmas(v, 8);  // the whole warp tile, unguarded\n"
            "    else if (nf_w > 0) mmas(v, nf_w);  // warp-uniform: a narrow slab\n",
            "    if (d < 0) mmas(v, nf_w);\n"),
           ("    if (nf_w == 8 && ksn == KS) mmas(v, KS, 8);  // unguarded\n"
            "    else if (nf_w > 0) mmas(v, ksn, nf_w);  // warp-uniform\n",
            "    if (d < 0) mmas(v, ksn, nf_w);\n")]
PROBES = {"no_mma": _NO_MMA, "no_copy": _NO_COPY, "no_split": _NO_SPLIT,
          "mma_only": _NO_COPY + _NO_SPLIT}


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
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = {"gbatc_project_batched": [P] * 3, "gbatc_correct_batched": [P] * 4,
            "gbatc_select_accumulate": [P] * 6, "gbatc_correct_masked": [P] * 5}
ROUTES = [(name, dt) for dt in ("float32", "float64")
          for name in ("gbatc_project_batched", "gbatc_correct_batched",
                       "gbatc_select_accumulate")]
TIMED = [(58, 1600, 512), (1, 65536, 256)]


def declare(cdll) -> dict:
    fns = {}
    for name, ptrs in ARGTYPES.items():
        for dt, suffix in (("float32", "f32"), ("float64", "f64")):
            fn = getattr(cdll, f"{name}_{suffix}")
            fn.restype = I
            fn.argtypes = ptrs + [I, L, I, I, P]
            fns[name, dt] = fn
    return fns


def call(fns, name, *ops):
    """One launch of route ``name`` on ``ops`` (the wrapper's operand order;
    the masked correct: x, c, mask, u on (NB, D) operands)."""
    lead = ops[0] if ops[0].dim() == 3 else ops[0][None]
    s, nb, d = lead.shape
    out = torch.empty_like(ops[0])
    dt = str(ops[0].dtype).split(".")[-1]
    if name == "gbatc_project_batched":
        ptrs = (ops[0], ops[1], out)
    else:
        ptrs = (*ops, out)
    rc = fns[name, dt](*(t.data_ptr() for t in ptrs), s, nb, d, 8,
                       torch.cuda.current_stream().cuda_stream)
    if rc:
        sys.exit(f"{name} ({dt}, {(s, nb, d)}) failed to launch: error {rc}")
    return out


def route_args(name, x, c, u, rank, m):
    return {"gbatc_project_batched": (x, u), "gbatc_correct_batched": (x, c, u),
            "gbatc_select_accumulate": (x, c, rank, m, u)}[name]


def error(got, want, rows, dtype) -> float:
    """``chip_smoke.compare``'s measure: max abs difference (fp32), or over
    the row's l2 norm (fp64); inf where the output is not finite."""
    if not torch.isfinite(got).all():
        return math.inf
    diff = (got - want).abs()
    if dtype == torch.float64:
        diff = diff / rows.norm(dim=-1, keepdim=True).clamp_min(1e-300)
    return float(diff.max()) if diff.numel() else 0.0


def check(fns, shapes) -> tuple[dict, list]:
    """Every route at every shape against its plain version; select bitwise
    its correct on the masked coefficients, and each route the same bits
    twice. Returns ({"max": {route: max error}, "by_shape": {route: error a
    shape}, "vs_fp64": {fp32 route and kernel or plain: max abs difference
    from the product in fp64}}, the failures)."""
    errs: dict = {}
    by_shape: dict = {}
    vs64: dict = {}
    bad: list = []
    limit = {torch.float32: cs.FP32_LIMIT, torch.float64: cs.FP64_REL_LIMIT}
    for i, (s, nb, d) in enumerate(shapes):
        for dt in ("float32", "float64"):
            dtype = getattr(torch, dt)
            x, c, u, rank, m = cs.make_inputs(torch, s, nb, d, dtype, 500 + i)
            for name, r_dt in ROUTES:
                if r_dt != dt:
                    continue
                args = route_args(name, x, c, u, rank, m)
                got = call(fns, name, *args)
                want = getattr(kref, name + "_ref")(*args)
                rows = x if name == "gbatc_project_batched" else c
                e = error(got, want, rows, dtype)
                errs[f"{name}/{dt}"] = max(errs.get(f"{name}/{dt}", 0.0), e)
                by_shape.setdefault(f"{name}/{dt}", []).append(e)
                if dtype == torch.float32:  # both against the same product in fp64
                    truth = getattr(kref, name + "_ref")(
                        *(a.double() if a.is_floating_point() else a for a in args))
                    for key, t in (("kernel", got), ("plain", want)):
                        k2 = f"{name}/{dt}/{key}"
                        vs64[k2] = max(vs64.get(k2, 0.0), float((t.double() - truth).abs().max()))
                    del truth
                if e > limit[dtype]:
                    bad.append([name, dt, [s, nb, d], e])
                if not torch.equal(got, call(fns, name, *args)):
                    bad.append([name, dt, [s, nb, d], "two launches differ"])
            kept = torch.where(rank < m[..., None], c, torch.zeros((), dtype=dtype,
                                                                   device=c.device))
            if not torch.equal(call(fns, "gbatc_select_accumulate", x, c, rank, m, u),
                               call(fns, "gbatc_correct_batched", x, kept, u)):
                bad.append(["select != correct on kept", dt, [s, nb, d]])
            del x, c, u, rank, m, kept
        torch.cuda.empty_cache()
    for nb, d in cs.GBATC_2D_ANY_D[:-1]:
        for dtype in (torch.float32, torch.float64):
            g = torch.Generator(device="cuda").manual_seed(nb + d)
            x, c = (torch.randn(nb, d, generator=g, device="cuda", dtype=dtype) for _ in "xc")
            u = torch.linalg.qr(torch.randn(d, d, generator=g, device="cuda",
                                            dtype=torch.float64))[0].to(dtype).contiguous()
            mask = (torch.rand(nb, d, generator=g, device="cuda") < 0.5).to(dtype)
            e = error(call(fns, "gbatc_correct_masked", x, c, mask, u),
                      kref.gbatc_correct_ref(x, c, mask, u), c, dtype)
            key = f"gbatc_correct_masked/{str(dtype).split('.')[-1]}"
            errs[key] = max(errs.get(key, 0.0), e)
            if e > limit[dtype]:
                bad.append(["gbatc_correct_masked", key, [nb, d], e])
    return {"max": errs, "by_shape": by_shape, "vs_fp64": vs64}, bad


def digests(fns) -> dict:
    """The checkout's sha256 at WIDE (MAIN_ROUTES) and ANY_D (ALL_ROUTES)."""
    out = {}
    for table, shapes, seed, routes in (("WIDE", cs.WIDE, cs.WIDE_SEED, cs.MAIN_ROUTES),
                                        ("ANY_D", cs.ANY_D, cs.ANY_D_SEED, cs.ALL_ROUTES)):
        for i, shape in enumerate(shapes):
            ops = cs.wide_digest_operands(torch, *shape, seed + i)
            out.setdefault(table, {})[str(list(shape))] = {
                f"{name}/{dt}": hashlib.sha256(call(fns, name, *ops[name, dt]).cpu().numpy()
                                               .tobytes()).hexdigest()
                for name, dt in routes}
            del ops
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an earlier gbatc_kernels.cu")
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--digests", action="store_true")
    ap.add_argument("--probes", action="store_true",
                    help="also time PROBES, the checkout with parts of its loop taken out")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=PATH",
                    help="a further source (an edit of the checkout's) to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/gbatc_wide_timing.py: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = {"parent": args.parent, "checkout": CHECKOUT}
    sources.update(v.split("=", 1) for v in args.variant)
    if args.probes:
        sources.update(probe_sources())
    libs = build(sources, stem="gbatc_kernels", kernels="wide", out=OUT)
    print(json.dumps({"build": {n: u for n, (_, u) in libs.items()}}), flush=True)
    print(cs.gpu_line(), flush=True)
    fns = {name: declare(cdll) for name, (cdll, _) in libs.items()}
    shapes = list(dict.fromkeys(cs.WIDE + cs.ANY_D))
    failed = False
    for name in ("checkout", "parent"):
        errs, bad = check(fns[name], shapes)
        print(json.dumps({"checks": name, "shapes": shapes, "max_err": errs,
                          "failures": bad}), flush=True)
        failed |= bool(bad)
    if args.digests:
        print(json.dumps({"digests": digests(fns["checkout"])}), flush=True)
    order = list(libs) + list(libs)[::-1]

    def timed(shape, route, name, args_, lib) -> None:
        """One line: every build timed in turns, and the library call."""
        row = {"shape": list(shape), "route": route, "ms": {}}
        for b in order:
            row["ms"].setdefault(b, []).append(cs.time_ms(
                torch, lambda: call(fns[b], name, *args_), args.launches))
        row["library_ms"] = cs.time_ms(torch, lib, args.launches) if lib else None
        mean = {b: sum(v) / len(v) for b, v in row["ms"].items()}
        row["parent_over_checkout"] = mean["parent"] / mean["checkout"]
        print(json.dumps(row), flush=True)

    for shape in TIMED:
        for name, dt in ROUTES:
            if shape == (1, 65536, 256) and dt == "float64":
                continue
            x, c, u, rank, m = cs.make_inputs(torch, *shape, getattr(torch, dt), 790)
            lib = {"gbatc_project_batched": lambda: torch.bmm(x, u),
                   "gbatc_correct_batched": lambda: torch.baddbmm(x, c, u.transpose(1, 2)),
                   "gbatc_select_accumulate": None}[name]
            timed(shape, f"{name}/{dt}", name, route_args(name, x, c, u, rank, m), lib)
            del x, c, u, rank, m
            torch.cuda.empty_cache()
    nb, d = cs.GBATC_2D_ANY_D[-1]
    g = torch.Generator(device="cuda").manual_seed(7)
    x, c = (torch.randn(nb, d, generator=g, device="cuda") for _ in "xc")
    u = torch.linalg.qr(torch.randn(d, d, generator=g, device="cuda",
                                    dtype=torch.float64))[0].float().contiguous()
    mask = (torch.rand(nb, d, generator=g, device="cuda") < 0.5).float()
    timed((nb, d), "gbatc_project_batched/float32 (2D)", "gbatc_project_batched", (x, u),
          lambda: torch.mm(x, u))
    timed((nb, d), "gbatc_correct_masked/float32 (2D)", "gbatc_correct_masked",
          (x, c, mask, u), None)
    print(cs.gpu_line(), flush=True)
    if failed:
        sys.exit("tools/gbatc_wide_timing.py: a build missed a check (see its line)")


if __name__ == "__main__":
    main()
