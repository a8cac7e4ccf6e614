#!/usr/bin/env python3
"""Time the ring design of ``rglru_scan`` against the choices it did not
take, and against another build of the kernel, in one process on one card.

Each variant is the checkout's ``kernels/csrc/rglru_scan.cu`` with one or
more of its constants edited (``GROUP``, ``T_TILE``, ``STAGES``,
``THREADS``) and lines replaced, built with the package's ``nvcc`` flags
into ``build/rglru_variants/`` and called through its C entry points:

* ``checkout``: the source as it is (3 ring slots, 32-step tiles, a chain
  warp and a producer warp, h staged a tile in shared memory);
* ``s2``, ``s4``: a ring of 2 or 4 slots;
* ``sh0``: h stored from registers a step at a time, not staged a tile in
  shared memory;
* ``t16``: 16-step tiles;
* ``pw0``: the chain warp issues its own copies (no producer warp);
* ``g16``: 16-channel groups (twice the CTAs; half the chain warp idles);
* ``l2_256``: the 16-byte copies ask L2 to fetch 256 bytes (``.L2::256B``:
  the next group's row too); ``stcs``: h stored with the streaming hint
  (``__stcs``);
* ``probe_*``: not candidates but probes of where the time goes, with a
  wrong h: ``probe_nochain`` drops the carry from the chain (``h_t = a_t +
  b_t``), ``probe_nostore`` stores no h, ``probe_nocopy`` copies nothing
  into the ring, ``probe_nocopy_nostore`` neither, ``probe_nocopy_nolds``
  copies nothing and reads no a or b from shared memory (h still stored).

``--baseline PATH`` adds a build of another source with the same C
interface, timed beside the others as ``baseline`` (for example an earlier
commit's ``rglru_scan.cu``, unpacked under ``build/``).

Prints each build's registers and spills, then one JSON
line a check and a shape: whether each variant's h and h_T are bitwise
the plain version's (fp32 and bf16, with and without h0, at ragged and
unaligned shapes), and at RecurrentGemma-2B's three fp32 shapes of
``chip_smoke.py`` each variant's median of 20 single CUDA-event launches
(``ms``: at these sizes it can time the host's side of a call, which
outlasts a fast kernel) and its mean over 100 back-to-back launches queued
behind a spin kernel (``device_ms``: the device alone), both taken twice in
turns (forward order, then reverse), beside the bytes bound.
Needs one H100-class card:

    python3 tools/rglru_variants.py [--baseline PATH] [VARIANT ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
from repro_torch.kernels import ref as kref  # noqa: E402

SRC = open(os.path.join(ROOT, "src/repro_torch/kernels/csrc/rglru_scan.cu")).read()


def edit(*texts, **values) -> str:
    """The source with its ring constants set to ``values`` and each
    (old, new) pair of ``texts`` replaced."""
    out = SRC
    for name, value in values.items():
        pattern = rf"constexpr (int|long long) {name} = \d+;"
        if len(re.findall(pattern, out)) != 1:
            sys.exit(f"tools/rglru_variants.py: the source no longer holds {pattern!r}")
        out = re.sub(pattern, rf"constexpr \1 {name} = {value};", out)
    for old, new in texts:
        if out.count(old) != 1:
            sys.exit(f"tools/rglru_variants.py: the source no longer holds {old!r}")
        out = out.replace(old, new)
    return out


CHAIN = "hc = __fadd_rn(__fmul_rn(at, hc), bv[j]);"
NOCOPY = ("if (p * RPP < left)", "if (false)")
CG = "cp.async.cg.shared.global [%0], [%1], 16;"
STORE = ("*reinterpret_cast<int4*>(hp + (size_t)r * w_len + c) =\n"
         "                  *reinterpret_cast<const int4*>(hbuf + r * GROUP + c);")
STCS = ("__stcs(reinterpret_cast<int4*>(hp + (size_t)r * w_len + c),\n"
        "                     *reinterpret_cast<const int4*>(hbuf + r * GROUP + c));")
VARIANTS = {
    "checkout": SRC,
    "s2": edit(STAGES=2),
    "s4": edit(STAGES=4),
    "sh0": edit(("STAGED = COPY == VEC16;", "STAGED = false;")),
    "t16": edit(T_TILE=16),
    "pw0": edit(("copier = !chain;", "copier = true;"), THREADS=32),
    # lanes past the group read the ring as the group's lanes do and stage
    # their (never stored) h in an h tile of 32 columns
    "g16": edit(("SLOT + lane;", "SLOT + lane % GROUP;"),
                ("hbuf + j * GROUP + lane", "hbuf + j * 32 + lane"),
                ("hbuf + r * GROUP + c", "hbuf + r * 32 + c"),
                ("(2 * STAGES + (COPY == VEC16))", "(2 * STAGES + 2 * (COPY == VEC16))"),
                GROUP=16),
    "l2_256": edit((CG, CG.replace("global [", "global.L2::256B ["))),
    "stcs": edit((STORE, STCS)),
    # probes of where the time goes, not candidates: their h is wrong
    "probe_nochain": edit((CHAIN, "hc = __fadd_rn(at, bv[j]);")),
    "probe_nostore": edit(("if (r < steps)", "if (false)")),
    "probe_nocopy": edit(NOCOPY),
    "probe_nocopy_nostore": edit(NOCOPY, ("if (r < steps)", "if (false)")),
    "probe_nocopy_nolds": edit(NOCOPY, ("av[j] = to_f(sa[j * GROUP]);", "av[j] = 0.5f;"),
                               ("bv[j] = to_f(sb[j * GROUP]);", "bv[j] = 1.0f;")),
}
TIMED = [cs.LM_RGLRU, (cs.LM_CHECK_BATCH, cs.LM_CHECK_PROMPT, 2560), cs.RGLRU_PATH]
# (B, T, W, dtype, h0 given, base offset in elements): both copy widths,
# ragged T and W, no h0, bases that are not 16-byte aligned
BITS = [(4, 2304, 2560, "float32", True, 0), (4, 2304, 2560, "bfloat16", True, 0),
        (2, 65, 160, "float32", False, 0), (1, 100, 130, "float32", True, 0),
        (1, 100, 130, "bfloat16", True, 0), (1, 50, 131, "bfloat16", True, 0),
        (3, 17, 20, "float32", False, 0), (2, 33, 256, "float32", True, 1),
        (2, 33, 256, "bfloat16", False, 1)]


def build(sources: dict) -> dict:
    out_dir = os.path.join(ROOT, "build", "rglru_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
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
                m = re.search(r"rglru_kernelI(f|13__nv_bfloat16)(?:Li(\d)E)?", ln)
                cur = m and "{}{}".format("f32" if m.group(1) == "f" else "bf16",
                                          f"/copy{m.group(2)}" if m.group(2) else "")
            elif cur and ("spill" in ln or "Used" in ln):
                usage[cur] = (usage.get(cur, "") + " " + ln.strip()[-80:]).strip()
        print(json.dumps({"variant": name, "ptxas": usage}), flush=True)
        lib_handle = ctypes.CDLL(lib)
        fns[name] = {}
        for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            fn = getattr(lib_handle, f"rglru_scan_{suffix}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fns[name][dtype] = fn
    return fns


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="another rglru_scan.cu to time beside the checkout's")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/rglru_variants.py: needs a CUDA device")
    names = ["checkout"] + [n for n in (args.variants or VARIANTS) if n != "checkout"]
    sources = {n: VARIANTS[n] for n in names}
    if args.baseline:
        with open(args.baseline) as f:
            sources["baseline"] = f.read()
        names.append("baseline")
    fns = build(sources)
    print(cs.gpu_line(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(900)

    def inputs(b, t, w, dtype, with_h0, offset=0):
        n = b * t * w
        a = torch.sigmoid(2.0 + torch.randn(n + offset, generator=g, device="cuda"))
        bb = torch.randn(n + offset, generator=g, device="cuda")
        a, bb = (x.to(dtype)[offset:].view(b, t, w) for x in (a, bb))
        h0 = torch.randn(b, w, generator=g, device="cuda") if with_h0 else None
        return a, bb, h0

    def call(name, a, bb, h0):
        b, t, w = a.shape
        h = torch.empty_like(a)
        h_last = torch.empty(b, w, device="cuda")
        rc = fns[name][a.dtype](a.data_ptr(), bb.data_ptr(),
                                0 if h0 is None else h0.data_ptr(), h.data_ptr(),
                                h_last.data_ptr(), b, t, w,
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            sys.exit(f"variant {name} failed to launch at {tuple(a.shape)}: error {rc}")
        return h, h_last

    for b, t, w, dtype, with_h0, offset in BITS:
        a, bb, h0 = inputs(b, t, w, getattr(torch, dtype), with_h0, offset)
        want = kref.rglru_scan_ref(a, bb, h0)
        row = {"check": [b, t, w, dtype, "h0" if with_h0 else "no h0", f"offset {offset}"]}
        for name in names:
            got = call(name, a, bb, h0)
            row[name] = all(torch.equal(x, y) for x, y in zip(got, want))
        print(json.dumps(row), flush=True)
        del a, bb, h0, want
    for b, t, w in TIMED:
        a, bb, h0 = inputs(b, t, w, torch.float32, True)
        want = kref.rglru_scan_ref(a, bb, h0)
        nbytes = 3 * b * t * w * 4 + 2 * b * w * 4
        row = {"shape": [b, t, w], "dtype": "float32",
               "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
        for name in names:
            got = call(name, a, bb, h0)
            row[name] = {"bitwise_plain": all(torch.equal(x, y) for x, y in zip(got, want)),
                         "ms": [], "device_ms": []}
        for name in names + names[::-1]:
            row[name]["ms"].append(cs.time_ms(torch, lambda: call(name, a, bb, h0), 20))
            row[name]["device_ms"].append(
                cs.device_ms(torch, lambda: call(name, a, bb, h0), 100))
        print(json.dumps(row), flush=True)
        del a, bb, h0, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
