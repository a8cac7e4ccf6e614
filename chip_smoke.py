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
   shape and every ragged one; every bf16 flash shape (causal, windows,
   non-causal, ragged Tk, D = 8 to 256, Tq = 1) within one bf16 ulp of
   each element's value plus 4e-5 (``bf16_ulp_ratio`` <= 1);
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
8. ``serve_path``  the decode service (``repro_torch.serve.DecodeService``)
   on the two codec paths' blobs (no new fit): a seeded mix of 64
   selective requests (4 duplicates, one unknown blob, one malformed)
   from 8 client threads, every answer bitwise the slice of its blob's
   full decode, exactly the planted requests failing, fewer fused
   dispatches than requests, and no kernel but the replay (and flash for
   the attention blob); the same mix served serially through
   ``PartialDecoder`` for comparison, both cold and both warm; one tick
   holding a corrupt species, its batch-mates and a salvage request; and
   the gap a fused decode shows when cuDNN's TF32 is on (what
   ``strict_fp32`` prevents);
9. ``stream_path``  ``GBATCCodec.fit_stream`` over the main field in
   chunks of 4 frames, one injected I/O fault in each ingest pass, then
   the 1e-3 compress: the blob must be main_path's byte for byte, with
   one projection and one select launch; then the QoI (net production
   rates, ``repro_torch.core.qoi``) of the field and of its decode on the
   card against the same map on the host;
10. ``mesh_path``  the mesh-sharded fit and compress (``repro_torch.parallel``)
   on main_path's field and fitted codec, over a mesh of 4 (``host_mesh(4)``
   on a machine with 4 cards, else ``(cuda:0,) * 4``): main_path's fitted
   state compressed through ``ShardedGuaranteeEngine`` with 4 and 116
   chunks (each blob main_path's byte for byte, one projection and one
   select launch a chunk, peak device memory against the default
   engine's); ``fit_stream`` on a 1-device mesh (main_path's blob); the
   data-parallel fit through ``GBATCCodec(mesh=...)`` (replicas bitwise
   equal, losses falling, the bound met, latents bitwise the one-device
   encode, decode bitwise); the int8 gradient exchange on ``block_quant``
   (one launch a shard a step, a sampled bucket bitwise its plain version,
   the bucket's kernel time against its bound);
11. ``lm_serve_path``  the language-model serving path
   (``repro_torch.models``, ``repro_torch.serve.Server``) on the card: (a)
   Llama-3.2-1B, StableLM-3B, Yi-9B, RWKV-6 7B, RecurrentGemma-2B and
   Whisper-base in fp32
   under ``strict_fp32`` at full width and depth from one seed's
   parameters, batch 2, prompt 2112 (past RecurrentGemma's 2048 window):
   the kernel route (``use_kernels=True``: flash, ``rwkv6_scan``,
   ``rglru_scan``) against the portable route (``use_kernels=False``) in
   prefill logits and four decode steps, within 1e-3 of the largest
   logit, and prefill(T) + ``decode_step`` against prefill(T+1) within the
   reference's 2e-2; then the same parameters cast to bf16 through both
   routes, each held against the fp32 portable logits: the kernel route
   no farther than twice the portable bf16 route, with both gaps, the
   last-position greedy agreement and both bf16 prefill times reported;
   (b) all ten configs in bf16 through ``Server``,
   greedy, batch 4, prompt 2304, 16 new tokens, full width (depth cut to
   8 of 48, 8 of 80 and 2 of 40 layers for the three largest), the same
   tokens twice, finite logits, ``kv_quant`` once for the two MoE
   configs; parameter bytes from meta tensors, peak memory, prefill and
   decode seconds and tokens/s, and a profiler breakdown of one prefill
   and four decode steps by kernel. Every prefill launches exactly its
   expected count of each kernel (flash once per attention layer,
   ``rwkv6_scan`` once per RWKV layer, ``rglru_scan`` once per recurrent
   block); decode steps and the portable route launch none. The
   ``kernels`` phase holds the three kernels at this path's shapes
   (flash at head dims 64, 80, 128 and 256) in fp32 and bf16 against their
   plain versions, bf16 within one bf16 ulp of each element's value and
   faster than its plain version, timed beside SDPA and their bounds;
12. ``lm_train_path``  the language-model training path
   (``repro_torch.train.train_loop.make_train_step``, ``launch.train.train``,
   ``train.checkpoint``) on the card, every step through the portable route
   (``use_kernels=False``: no kernel has a backward): (1) one train step of
   each of the ten ``.smoke()`` configs in fp32 under ``strict_fp32`` on the
   card and on the CPU from the same parameters, the loss and every
   gradient leaf within 1e-4 of the leaf's largest |g|; (2) Llama-3.2-1B at
   full width and depth in bf16 with ``remat="full"``, batch 4, seq 2048,
   30 AdamW steps with the int8 gradient compression: losses falling,
   exactly one ``block_quant`` launch a gradient leaf a step and no other
   kernel, one launch a step (every leaf in turn, embed and lm_head at
   (4.1 M, 64) among them) bitwise its plain version on the same gradient,
   peak memory (this step alone allocates in expandable segments), and a
   profiler split (forward+backward / ``compress_tree`` / AdamW, device
   idle share) over 4 more steps, whose seconds give the step time,
   tokens/s and MFU; (3) the same model cut to 2 layers, seq 512, 10 steps under
   ``run_with_recovery`` with a checkpoint every 4 steps, once with a
   ``StepFailure`` at step 6 and once without: final parameters and
   optimizer state bitwise equal, the restore bitwise what was saved, each
   save timed; (4) ``compress_state_bytes`` at tau_rel 1e-3 of the layer-0
   slice of every stacked leaf of (2)'s trained model: one fp64 projection
   and one fp32 select launch a leaf at D = 256, each held against its
   plain version on the engine's operands, every 256-block within its
   bound, the ratio and the seconds of prepare, select and entropy coding;
   (5) ``python -m repro_torch.launch.train --steps 20`` in a subprocess:
   exit 0 and a falling loss. The ``kernels`` phase holds the wide
   instantiations (128 < D <= 256) of the fp64 projection and the fp32
   select and correct at every ``WIDE`` shape (``batched_checks``, as at
   D = 80) and times them at (1, 65536, 256);
13. ``dryrun_path``  the dry run (``repro_torch.launch.dryrun``, meta tensors
   only): (1) ``python -m repro_torch.launch.dryrun --arch <a> --mesh both``
   for every config, in subprocesses started together: each exits 0 with
   CUDA never initialised and writes exactly its cells (64 in all: 32 a
   mesh), one line a cell with its per-device argument and output GB
   beside the card's memory (temp bytes not included) and its global
   FLOPs; (2) Llama-3.2-1B at lm_train_path's full-width cell (bf16, remat
   full, batch 4, seq 2048, no compression, ``use_kernels=False``): the dry
   run's meta count equals, as an integer, ``FlopCounterMode`` around one
   real ``make_train_step`` step on the card, and around one real
   ``decode_step`` at batch 4 on a cache of 4096 (the step has no branch on
   the device, so this shows that none crept in and that the dry run's
   lean counter agrees with torch's; the tests hold the same two counts to
   the reference step's jaxpr); the counted FLOPs a token beside the
   6 N + 12 L H D T rule, and the hardware-FLOPs utilisation beside the
   MFU over the step's median time; (3) the storage bytes of the real
   training state (params, AdamW moments, batch) equal the dry run's
   argument bytes on a (1, 1) mesh less the 4-byte step count the port
   keeps on the host, and the storage of the step's outputs its output
   bytes less the tuple's table and the step count and learning rate the
   port keeps on the host (likewise the decode step's arguments and its
   logits and cache), with the step's peak less the argument bytes
   reported;
14. ``analysis_path``  the invariant checker (``repro_torch.analysis``) on
   the card: (1) ``python -m repro_torch.analysis`` in a subprocess (the
   AST lint, the wire schema and the trace audit at its tiny shapes on the
   card) exits 0; (2) meanwhile the audit's registry of 13 hot programs
   runs in this process at the main path's width, on main_path's fitted
   state and attention_path's artifact (58 species, NB = 20480, D = 80; the
   attention decode at (4096, 2, 232, 16)): every aten op under a
   dispatch recorder and ``torch.cuda.set_sync_debug_mode("error")`` (the
   ``log_every`` program under ``"warn"``, its syncs counted), no finding,
   and each program's own kernel launched (the fp64 projection, the fp32
   select and correct, flash in the attention decode, ``block_quant`` in
   the quantized data-parallel step); one line a program with its ops,
   host syncs, fp64 ops, transfers and launches;
15. the ``{"kernels": [...]}`` line, the card line, and the final ``ok`` line.

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
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12,  # fp64: tensor-core DMMA rate
              "bfloat16": 989e12}

S, NB, D = 58, 20480, 80  # main-path kernel shapes (T=16, 320x320, block 4x5x4)
RAGGED = [(3, 513, 80), (5, 513, 64), (2, 1, 80), (4, 100, 37), (2, 77, 128),
          (3, 45, 97)]
FP32_LIMIT = 1e-5  # max abs difference, unit-scale inputs, fp32 accumulate order
FP64_REL_LIMIT = 1e-12  # max abs difference relative to the row's l2 norm
# row ranges of the fp64 projection's sub-range checks: each starts inside
# a 64-row tile, so its rows meet other tile and fragment positions
PROJECT_SUBRANGES = [(100, 5003), (20417, 20480), (1, 2)]
# the wide kernels (128 < D <= 256: the fp64 projection, fp32 select and
# correct) at the weight checkpoint's D = 256 (train/checkpoint.py): the
# blocks of Llama-3.2-1B's largest layer-0 leaf (2048 x 8192 = 65536
# blocks; timed), and ragged shapes, D = 129 and 200 among them
WIDE = [(1, 65536, 256), (2, 513, 256), (1, 1, 256), (3, 100, 200), (2, 77, 129)]
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
    (1, 2, 256, 256, 64, True, 16, ("float32", "bfloat16")),
    (1, 2, 256, 256, 64, True, 64, ("float32", "bfloat16")),
    (1, 2, 256, 256, 64, True, 1000, ("float32", "bfloat16")),
    (1, 1, 128, 256, 64, False, 0, ("float32", "bfloat16")),
    (2, 2, 232, 232, 16, False, 0, ("float32", "bfloat16")),
    (3, 2, 1, 16, 16, False, 0, ("float32", "bfloat16")),
    (1, 2, 100, 37, 8, False, 0, ("float32", "bfloat16")),
    (2, 1, 70, 300, 128, False, 24, ("float32", "bfloat16")),
]
# the reference's tolerances (tests/test_kernels.py::_tol), max abs diff
FLASH_LIMIT = {"float32": 2e-5, "bfloat16": 2e-2}
# and in bf16 at every element: the kernel and its plain version both keep
# fp32 between the bf16 loads and round the output to bf16 once, so an
# element may differ by one bf16 ulp of its value (at most 2^-7 |plain|)
# plus twice the fp32 gap; the ratio of |kernel - plain| to that allowance
# (bf16_ulp_ratio) must stay <= 1
BF16_ULP = 2.0 ** -7


def bf16_ulp_ratio(diff, want) -> float:
    """max |kernel - plain| / (2^-7 |plain| + 2 FLASH_LIMIT["float32"])."""
    return float((diff / (BF16_ULP * want.float().abs()
                          + 2 * FLASH_LIMIT["float32"])).max())

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
            *m.groups()[1:])), (
        r"project_f64_wideILi(\d+)ELi(\d+)E",
        lambda m: "f64/project/wide/tm{}/stages{}".format(*m.groups())), (
        r"correct_f32_wideILi(\d)E",
        lambda m: "f32/{}/wide".format(
            ("project", "correct", "select", "masked")[int(m.group(1))]))],
    "flash_attention": [(
        r"flash_kernelIfLi(\d+)E",
        lambda m: "flash/f32/dp{}".format(m.group(1))), (
        r"flash_bf16_mmaILi(\d+)E",
        lambda m: "flash/bf16/mma/dp{}".format(m.group(1)))],
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
    most of those two, or, where no innermost loop holds any (a key loop
    around its tile copies), of the loop that does (``cuobjdump -sass`` of
    the built library); empty where cuobjdump is missing."""
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
            for innermost in (True, False):
                for lo, hi in spans:
                    if innermost and any(lo <= a and b <= hi and (a, b) != (lo, hi)
                                         for a, b in spans):
                        continue
                    body = [o for a, o in ins if lo <= a <= hi]
                    ffma = sum(o.startswith("FFMA") for o in body)
                    mma = sum(o.startswith(("HMMA", "DMMA")) for o in body)
                    if ffma + mma and (best is None or ffma + mma > best[1] + best[2]):
                        best = (len(body), ffma, mma)
                if best:
                    break
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


def device_ms(torch, fn, launches: int = 200) -> float:
    """Mean device time of ``launches`` back-to-back launches: a spin
    kernel first holds the stream while the host queues them all, so a
    call whose host side outlasts its kernel is timed on the device
    alone (``time_ms`` then times the host)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of cycles
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


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


def batched_checks(torch, s, nb, d, seed, err: dict) -> None:
    """Every check of the three batched kernels at (s, nb, d), on each
    (kernel, dtype) route that takes this D: against its plain version
    (FP64_REL_LIMIT, FP32_LIMIT; the largest difference kept in
    ``err[name, dtype]``); the fp64 projection the same bits twice and for
    row (PROJECT_SUBRANGES, clipped to nb) and species sub-ranges; the fp32
    select and correct under fp32_pair_bits."""
    from repro_torch.kernels import gbatc_project as gk
    from repro_torch.kernels import ref as kref

    for dtype in (torch.float32, torch.float64):
        x, c, u, rank, m = make_inputs(torch, s, nb, d, dtype, seed)
        for name, args, rows in (("gbatc_project_batched", (x, u), x),
                                 ("gbatc_correct_batched", (x, c, u), c),
                                 ("gbatc_select_accumulate", (x, c, rank, m, u), c)):
            if d > gk.MAX_D and (name, dtype) not in gk._WIDE:
                continue
            e = compare(torch, getattr(gk, name)(*args),
                        getattr(kref, name + "_ref")(*args), rows, dtype)
            err[name, dtype] = max(err.get((name, dtype), 0.0), e)
        if dtype == torch.float32:
            fp32_pair_bits(torch, gk, x, c, u, rank, m)
            continue
        what = f"gbatc_project_batched (fp64, {(s, nb, d)})"
        full = gk.gbatc_project_batched(x, u)
        same_twice(torch, what, lambda: gk.gbatc_project_batched(x, u))
        ranges = [(a, min(b, nb)) for a, b in PROJECT_SUBRANGES if a < nb]
        same_rows(torch, what, full,
                  [((slice(None), slice(a, b)), gk.gbatc_project_batched(
                      x[:, a:b].contiguous(), u)) for a, b in ranges]
                  + ([((slice(1, 3),), gk.gbatc_project_batched(
                      x[1:3].contiguous(), u[1:3].contiguous()))] if s > 1 else []))
        del full
    del x, c, u, rank, m
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def batched_rows(torch, shape, seed, launches, err: dict, **extra) -> list[dict]:
    """The fp64 projection and the fp32 select and correct timed at
    ``shape`` beside their plain versions, bounds and library yardsticks
    (``torch.bmm``, ``torch.baddbmm``; no one call computes the select);
    ``max_abs_err`` is ``err``'s, from batched_checks."""
    from repro_torch.kernels import gbatc_project as gk
    from repro_torch.kernels import ref as kref

    s, nb, d = shape
    n = s * nb * d
    rows = []

    def row(name, line, dtype, fn, plain, lib, nbytes, flops):
        rows.append(kernel_row(
            torch, name, "gbatc_kernels.cu",
            f"src/repro/kernels/gbatc_project.py:{line}", fn, plain, lib,
            str(dtype).split(".")[-1], shape, nbytes, flops, launches,
            err[name, dtype],
            tolerance=("max abs diff <= 1e-12 x row l2 norm"
                       if dtype == torch.float64 else "max abs diff <= 1e-5"),
            **extra))

    x, _, u, _, _ = make_inputs(torch, s, nb, d, torch.float64, seed)
    row("gbatc_project_batched", 207, torch.float64,
        lambda: gk.gbatc_project_batched(x, u),
        lambda: kref.gbatc_project_batched_ref(x, u),
        lambda: torch.bmm(x, u), (2 * n + s * d * d) * 8, 2 * n * d)
    del x, u
    torch.cuda.empty_cache()
    x, c, u, rank, m = make_inputs(torch, s, nb, d, torch.float32, seed + 1)
    kept = int((rank < m[..., None]).sum())
    row("gbatc_select_accumulate", 288, torch.float32,
        lambda: gk.gbatc_select_accumulate(x, c, rank, m, u),
        lambda: kref.gbatc_select_accumulate_ref(x, c, rank, m, u), None,
        (4 * n + s * nb + s * d * d) * 4, 2 * kept * d)
    ut = u.transpose(1, 2)
    row("gbatc_correct_batched", 240, torch.float32,
        lambda: gk.gbatc_correct_batched(x, c, u),
        lambda: kref.gbatc_correct_batched_ref(x, c, u),
        lambda: torch.baddbmm(x, c, ut), (3 * n + s * d * d) * 4, 2 * n * d)
    del x, c, u, rank, m, ut
    torch.cuda.empty_cache()
    return rows


def phase_kernels(torch, launches: int) -> list[dict]:
    from repro_torch.kernels import gbatc_project as gk
    from repro_torch.kernels import ref as kref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- the main-path shape and ragged / odd shapes, both dtypes ---------
    err: dict = {}
    batched_checks(torch, S, NB, D, 1, err)
    for i, (s, nb, d) in enumerate(RAGGED):
        batched_checks(torch, s, nb, d, 100 + i, err)
    # the replay's shapes on partial_path's selective decodes
    for i, (s, nb) in enumerate(PARTIAL_CORRECT_SHAPES):
        x, c, u, _, _ = make_inputs(torch, s, nb, D, torch.float32, 150 + i)
        e = compare(torch, gk.gbatc_correct_batched(x, c, u),
                    kref.gbatc_correct_batched_ref(x, c, u), c, torch.float32)
        err["gbatc_correct_batched", torch.float32] = max(
            err["gbatc_correct_batched", torch.float32], e)
    del x, c, u
    torch.cuda.empty_cache()

    # -- main-path shapes: fp64 projection, fp32 select and replay, timed -
    rows = batched_rows(torch, (S, NB, D), 1, launches, err,
                        ragged_shapes_checked=RAGGED)
    rows[2]["partial_shapes_checked"] = PARTIAL_CORRECT_SHAPES
    wide = phase_wide_kernels(torch, launches)
    for r in rows:
        r["wide_shapes"] = wide[r["name"]]
    emit({"phase": "kernels", "launches_timed": launches,
          "summary": [{k: r[k] for k in ("name", "dtype", "max_abs_err", "ms",
                                         "plain_ms", "library_ms", "bound_ms")}
                      for r in rows],
          "wide": wide})
    return rows


def phase_wide_kernels(torch, launches: int) -> dict:
    """The wide instantiations (128 < D <= 256: the fp64 projection, the
    fp32 select and correct) under batched_checks at every WIDE shape, and
    timed at WIDE[0]. Returns {kernel: entry}."""
    err: dict = {}
    for i, (s, nb, d) in enumerate(WIDE):
        batched_checks(torch, s, nb, d, 300 + i, err)
    out = {}
    for r in batched_rows(torch, WIDE[0], 390, launches, err, shapes_checked=WIDE):
        for k in ("route", "source", "replaces", "launches"):
            r.pop(k)
        out[r.pop("name")] = r
    return out


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
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ratio = bf16_ulp_ratio(diff, want) if dtype_name == "bfloat16" else 0.0
        if err > FLASH_LIMIT[dtype_name] or ratio > 1.0:
            fail(f"flash_attention differs from its plain version by {err:.3e} "
                 f"(limit {FLASH_LIMIT[dtype_name]}), bf16 ulp ratio {ratio:.3f} "
                 f"(limit 1; {dtype_name}, shape {tuple(q.shape)}/{k.shape[2]}, "
                 f"causal={causal}, window={window})")
        return err, ratio

    errs = {"float32": 0.0, "bfloat16": 0.0}
    ulp_ratio = 0.0  # the largest over the bf16 entries

    def note(q, k, v, causal, window, name):
        nonlocal ulp_ratio
        err, ratio = check(q, k, v, causal, window, name)
        errs[name] = max(errs[name], err)
        ulp_ratio = max(ulp_ratio, ratio)

    for i, (b, h, tq, tk, d, causal, window, dtypes) in enumerate(FLASH_SHAPES):
        for name in dtypes:
            note(*qkv(b, h, tq, tk, d, getattr(torch, name), 200 + i), causal, window, name)

    b, h, t, d = FLASH_PATH
    q, k, v = qkv(b, h, t, t, d, torch.bfloat16, 300)
    note(q, k, v, False, 0, "bfloat16")
    ms_bf16 = time_ms(torch, lambda: fk.flash_attention(q, k, v, causal=False),
                      launches)
    q, k, v = qkv(b, h, t, t, d, torch.float32, 301)
    err, _ = check(q, k, v, False, 0, "float32")
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
        max_abs_err_bf16=errs["bfloat16"], bf16_ulp_ratio=ulp_ratio,
        ms_bf16=ms_bf16,
        library_max_abs_err=float((sdpa() - plain()).abs().max()),
        shapes_checked=[list(c[:7]) + [list(c[7])] for c in FLASH_SHAPES],
        tolerance=("max abs diff <= 2e-5 (fp32), 2e-2 (bf16); bf16 also |diff| "
                   f"<= 2^-7 |plain| + {2 * FLASH_LIMIT['float32']} at every element"))
    del q, k, v
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "flash_attention",
          "launches_timed": launches,
          "summary": {k: row[k] for k in ("max_abs_err", "max_abs_err_bf16",
                                          "bf16_ulp_ratio", "ms", "ms_bf16",
                                          "plain_ms", "library_ms",
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


def s3d_config(args):
    from repro_torch.data import s3d

    return s3d.S3DConfig(n_species=58, n_time=args.frames, height=args.height,
                         width=args.width, seed=args.seed)


def generate(args):
    """The codec paths' field and its temperature (the QoI's input)."""
    from repro_torch.data import s3d

    t0 = time.perf_counter()
    ds = s3d.generate(s3d_config(args))
    return ds["species"], ds["temperature"], time.perf_counter() - t0


def drive(torch, data, cfg, args, name: str, widths: dict,
          ae_steps: int) -> tuple:
    """Fit + compress at 1e-3, decompress from the bytes, a second bound on
    the same fit, with every gate of the path; returns (info, blob,
    artifact, field, codec): the path line, the 1e-3 blob, its artifact,
    its decoded field and the fitted codec. Launch counts are reset just before each of the three
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
    return info, blob, rep.artifact, field, gb


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


def main_config(args):
    """main_path's PipelineConfig (stream_path fits the same one)."""
    from repro_torch.core.pipeline import PipelineConfig

    return PipelineConfig(latent=36, conv_channels=(32, 64), use_correction=True,
                          ae_steps=args.ae_steps, corr_steps=args.corr_steps,
                          seed=args.seed)


def phase_main_path(torch, args, data) -> dict:
    cfg = main_config(args)
    info, blob, artifact, field, gb = drive(torch, data, cfg, args, "main_path", {
        "species": 58, "block": [4, 5, 4], "latent": 36,
        "conv_channels": [32, 64], "correction": [232, 464, 232]}, args.ae_steps)
    emit(info)
    # mesh_path compresses this fit again; its prepared state goes now
    gb.pipeline.set_guarantee_engine(gb.pipeline._gengine)
    return info, blob, artifact, field, gb


def phase_attention_path(torch, args, data) -> dict:
    from repro_torch.core.container import ContainerReader
    from repro_torch.core.pipeline import PipelineConfig

    cfg = PipelineConfig(family="attention", arch=(32, 2, 1, 64), latent=36,
                         use_correction=True, ae_steps=args.attn_ae_steps,
                         corr_steps=args.corr_steps, seed=args.seed)
    info, blob, artifact, field, _ = drive(torch, data, cfg, args, "attention_path", {
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
    return info, blob, field, artifact


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


# serve_path: SERVE_CLIENTS threads submit SERVE_PER_CLIENT requests each.
# A request takes 1-4 of the 58 species, or all of them one time in
# SERVE_ALL_SPECIES; a window of 1-16 frames or the whole field; the
# attention blob one time in SERVE_ATTENTION. Planted among them:
# SERVE_DUPLICATES exact duplicates, one unknown blob id, one malformed
# request (species=99).
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_MAX_BATCH = 8, 8, 32
SERVE_ALL_SPECIES, SERVE_ATTENTION, SERVE_DUPLICATES = 16, 8, 4
# a serving box holding the two hot blobs keeps every species' decoded
# guarantee artifacts (about 0.5 GB for a 1e-3 blob of 58 x 20480 blocks)
SERVE_GUARANTEE_CACHE = 2 << 30
# the QoI on the card against the same map on the host: per species, as a
# share of that species' largest |rate|; the bound tests/test_torch_baselines.py
# holds the port's map to against the reference's
QOI_RTOL = 5e-5


def serve_requests(rng, s_all: int, t_all: int) -> list:
    """The seeded request mix: (blob_id, species, time_range) in client
    order (client i has entries [i*SERVE_PER_CLIENT, (i+1)*...))."""
    n = SERVE_CLIENTS * SERVE_PER_CLIENT
    reqs = []
    for _ in range(n):
        blob_id = "attention" if rng.integers(0, SERVE_ATTENTION) == 0 else "conv"
        if rng.integers(0, SERVE_ALL_SPECIES) == 0:
            species = None
        else:
            k = int(rng.integers(1, 5))
            species = sorted(int(i) for i in rng.choice(s_all, size=k, replace=False))
            if k == 1 and rng.integers(0, 2):
                species = species[0]  # an int squeezes the species axis
        if rng.integers(0, 4) == 0:
            window = None
        else:
            length = int(rng.integers(1, t_all + 1))
            t0 = int(rng.integers(0, t_all - length + 1))
            window = (t0, t0 + length)
        reqs.append((blob_id, species, window))
    slots = [int(i) for i in rng.permutation(n)[: SERVE_DUPLICATES + 2]]
    for slot in slots[:SERVE_DUPLICATES]:
        src = int(rng.integers(0, n))
        while src in slots:
            src = int(rng.integers(0, n))
        reqs[slot] = reqs[src]
    reqs[slots[-2]] = ("missing", 0, None)
    reqs[slots[-1]] = ("conv", 99, None)
    return reqs


def phase_serve_path(torch, args, conv: tuple, attention: tuple) -> dict:
    """The decode service on the card, on the two codec paths' 1e-3 blobs
    and decoded fields (no new fit): ``conv`` is (blob, artifact, field),
    ``attention`` (blob, field). Five counted runs, each with the launch
    counts reset just before it and read just after: the request mix
    served serially through PartialDecoder and then by the service from
    8 client threads, both cold and then both warm (every answer of each
    gated bitwise, the service's stats gated), then one tick with a
    corrupt species. Also measures the gap strict_fp32 guards against."""
    import threading
    from concurrent.futures import Future

    import numpy as np

    from repro_torch import codec
    from repro_torch.codec import cache as tiers
    from repro_torch.codec import runtime
    from repro_torch.core.container import ContainerFormatError
    from repro_torch.device import strict_fp32
    from repro_torch.serve import DecodeService
    from repro_torch.serve.decode_service import _Pending
    from repro_torch.testing.faults import FaultInjector, blob_regions

    t_start = time.perf_counter()
    blob, _, field = conv
    a_blob, a_field = attention
    blobs = {"conv": blob, "attention": a_blob}
    fields = {"conv": field, "attention": a_field}
    s_all, t_all = field.shape[:2]
    reqs = serve_requests(np.random.default_rng([args.seed, 18]), s_all, t_all)
    planted = {i for i, (b, sp, _) in enumerate(reqs) if b == "missing" or sp == 99}
    codec.configure_decode_cache(guarantee_bytes=SERVE_GUARANTEE_CACHE)

    def check_answer(i, got, what):
        b, sp, win = reqs[i]
        if i in planted:
            want = KeyError if b == "missing" else ValueError
            if not isinstance(got, want):
                fail(f"serve_path: {what}: planted request {reqs[i]} gave "
                     f"{type(got).__name__}, expected {want.__name__}")
            return
        if isinstance(got, BaseException):
            fail(f"serve_path: {what}: request {reqs[i]} raised {got!r}")
        want = sliced(fields[b], sp, win)
        if got.shape != want.shape or got.dtype != want.dtype or \
                got.tobytes() != want.tobytes():
            fail(f"serve_path: {what}: request {reqs[i]} is not bitwise the "
                 f"slice of the {b} blob's full decode")

    def only_replay(counts, what):
        others = {k: n for k, n in counts.items()
                  if k not in ("gbatc_correct_batched", "flash_attention") and n}
        if others or counts["gbatc_correct_batched"] < 1:
            fail(f"serve_path: {what} launched {counts}; expected only "
                 "gbatc_correct_batched (and flash_attention)")

    def serial():
        decoders, out = {}, []
        for b, sp, win in reqs:
            try:
                if b not in blobs:
                    raise KeyError(f"unknown blob_id {b!r}")
                if b not in decoders:
                    decoders[b] = codec.PartialDecoder(blobs[b])
                out.append(decoders[b].decode(sp, win))
            except (KeyError, ValueError) as e:
                out.append(e)
        return out

    def served():
        """The mix from SERVE_CLIENTS client threads, each submitting its
        requests and then waiting for them; returns (answers, stats)."""
        results = [None] * len(reqs)
        svc = DecodeService(max_batch=SERVE_MAX_BATCH)
        for b, bb in blobs.items():
            svc.register(b, bb)

        def client(c):
            mine = range(c * SERVE_PER_CLIENT, (c + 1) * SERVE_PER_CLIENT)
            futs = {i: svc.submit(*reqs[i]) for i in mine}
            for i, fut in futs.items():
                try:
                    results[i] = fut.result(timeout=600)
                except Exception as e:  # checked in the main thread
                    results[i] = e

        with svc:
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        return results, svc.stats

    runs = {}
    for mode in ("cold", "warm"):
        # cold: after clear_decode_cache(); warm: the cache then holds every
        # parsed head, latent shard and guarantee artifact the mix touched
        for way, fn in (("serial", serial), ("service", served)):
            if mode == "cold":
                codec.clear_decode_cache()
            out, secs, counts = counted(torch, fn)
            answers, st = out if way == "service" else (out, None)
            for i, got in enumerate(answers):
                check_answer(i, got, f"{way} {mode}")
            del answers, out
            only_replay(counts, f"the {way} run ({mode})")
            runs[f"{way}_{mode}"] = {
                "seconds": secs, "requests_per_s": len(reqs) / secs,
                "replay_launches": counts["gbatc_correct_batched"],
                "flash_launches": counts["flash_attention"],
                **(st.as_dict() if st else {}), "counts": counts}
            if st is None:
                continue
            # the gates of the service
            if st.requests != len(reqs) or st.completed + st.errors != st.requests:
                fail(f"serve_path: stats {st.as_dict()} do not add up to "
                     f"{len(reqs)} requests")
            if st.errors != len(planted):
                fail(f"serve_path: {st.errors} requests failed, {len(planted)} "
                     "were planted")
            if not st.dispatches < st.requests:
                fail(f"serve_path: {st.dispatches} dispatches for {st.requests} "
                     "requests")
            if not counts["flash_attention"]:
                fail("serve_path: the attention blob's requests launched no "
                     "flash_attention")

    # -- 3. one tick with a corrupt species --------------------------------
    regions = {r.label: r for r in blob_regions(blob)}
    bad, _ = FaultInjector(seed=5).flip_bit(blob, regions["guarantee:s7:coeff"])
    win = (4, 12)
    tick = [_Pending("bad", [7], win, "raise", Future()),
            _Pending("bad", [6], win, "raise", Future()),
            _Pending("bad", [8, 9], win, "raise", Future()),
            _Pending("bad", [6, 7, 8], win, "salvage", Future())]
    bad_svc = DecodeService()
    bad_svc.register("bad", bad)
    _, tick_s, tick_counts = counted(torch, lambda: bad_svc._tick(tick))
    e = tick[0].future.exception(0)
    if not isinstance(e, ContainerFormatError) or (e.stream, e.unit) != ("guarantee", 7):
        fail(f"serve_path: the species-7 request gave {e!r}, expected "
             "ContainerFormatError naming (guarantee, 7)")
    for req, sp in ((tick[1], [6]), (tick[2], [8, 9])):
        got, want = req.future.result(0), sliced(field, sp, win)
        if got.tobytes() != want.tobytes() or got.shape != want.shape:
            fail(f"serve_path: batch-mate {sp} of the corrupt species is not bitwise")
    salv, report = tick[3].future.result(0)
    clean = sliced(field, [6, 7, 8], win)
    if report.quarantined != [7] or not np.isnan(salv[1]).all() or \
            salv[[0, 2]].tobytes() != clean[[0, 2]].tobytes():
        fail(f"serve_path: salvage quarantined {report.quarantined}; expected NaN "
             "exactly on species 7 and the clean decode elsewhere")
    bst = bad_svc.stats
    if bst.fallbacks < 1 or bst.errors != 1 or bst.completed != 3 or bst.salvaged != 1:
        fail(f"serve_path: corrupt tick stats {bst.as_dict()}")
    for k in ("gbatc_project_batched", "gbatc_select_accumulate"):
        if tick_counts[k]:
            fail(f"serve_path: the corrupt tick launched {k}")
    dev = torch.device("cuda", torch.cuda.current_device())
    if runtime._head_key(bad, dev) in runtime._CACHE.heads:
        fail("serve_path: the corrupt blob's head stayed in the decode cache")

    # -- what strict_fp32 guards: one fused chunk under the flags a thread
    # saw when another left strict_fp32 first (cuDNN TF32 on, autotuning
    # and determinism off) against the strict chunk
    head = runtime._cached_head(blob)
    rows = min(runtime._FUSED_CHUNK, head.nb)
    lat = torch.from_numpy(runtime._latents32(
        head.latents.rows(0, rows), head.latent_bin)).to(head.runtime.device)
    with torch.no_grad(), strict_fp32():
        strict = head.runtime.fused(head.dec_state, head.corr_state, lat)
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic)
    cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = True, False, False
    try:
        with torch.no_grad():
            loose = head.runtime.fused(head.dec_state, head.corr_state, lat)
    finally:
        cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = saved
    torch.cuda.synchronize()
    gap = float((loose - strict).abs().max())
    tf32_gap = {"rows": rows, "max_abs": gap,
                "max_abs_over_max": gap / float(strict.abs().max()),
                "bitwise": bool(torch.equal(loose, strict))}
    del head, lat, strict, loose
    codec.configure_decode_cache(guarantee_bytes=tiers.DEFAULT_GUARANTEE_BYTES)

    n_ok = len(reqs) - len(planted)
    info = {
        "phase": "serve_path", "requests": len(reqs),
        "mix": {"clients": SERVE_CLIENTS, "per_client": SERVE_PER_CLIENT,
                "max_batch": SERVE_MAX_BATCH,
                "attention": sum(b == "attention" for b, _, _ in reqs),
                "all_species": sum(sp is None for _, sp, _ in reqs),
                "whole_field": sum(w is None for _, _, w in reqs),
                "duplicates": SERVE_DUPLICATES, "planted_failures": len(planted),
                "guarantee_cache_bytes": SERVE_GUARANTEE_CACHE},
        **{k: {kk: vv for kk, vv in v.items() if kk != "counts"}
           for k, v in runs.items()},
        "answers_bitwise": n_ok,
        "corrupt_tick": {"seconds": tick_s, **bst.as_dict(),
                         "raised": [e.stream, e.unit, e.offset],
                         "quarantined": report.quarantined},
        "strict_fp32_gap": tf32_gap,
        "launches": {**{k: v["counts"] for k, v in runs.items()},
                     "corrupt_tick": tick_counts},
        "seconds": time.perf_counter() - t_start,
    }
    emit(info)
    return info


class PassFaults:
    """A chunk loader whose ``chunks()`` calls numbered in ``fail_on``
    (from 0) raise OSError after their second chunk: with the two ingest
    passes of fit_stream, calls 0 and 2 are one fault in each pass."""

    def __init__(self, inner, fail_on):
        self._inner, self._fail_on = inner, set(fail_on)
        self.calls, self.faults = 0, []
        self.shape = inner.shape

    def chunks(self):
        call, self.calls = self.calls, self.calls + 1
        for n, c in enumerate(self._inner.chunks(), 1):
            yield c
            if call in self._fail_on and n == 2:
                self.faults.append(call)
                raise OSError(f"injected read fault in chunks() call {call}")


def phase_stream_path(torch, args, main_info: dict, data, temperature,
                      field) -> dict:
    """Streaming ingest on the card: fit_stream over the main field in
    chunks of 4 frames with one injected OSError in each pass, then the
    1e-3 compress; the blob must be main_path's, byte for byte. Then the
    QoI (net production rates) of the field and of its decode on the card
    against the same map on the host. Launch counts are reset just before
    the fit and read just after the compress."""
    import numpy as np

    from repro_torch.core import metrics, qoi
    from repro_torch.core.pipeline import GBATCCodec
    from repro_torch.data import s3d

    t_start = time.perf_counter()
    target = 1e-3
    loader = PassFaults(s3d.S3DChunkLoader(s3d_config(args), chunk_frames=4),
                        fail_on={0, 2})
    sleeps = []
    torch.cuda.reset_peak_memory_stats()

    def fit_and_compress():
        t0 = time.perf_counter()
        gb = GBATCCodec(main_config(args)).fit_stream(loader, _sleep=sleeps.append)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        return gb, fit_s, gb.compress_report(target_nrmse=target)

    (gb, fit_s, (blob, rep)), total_s, counts = counted(torch, fit_and_compress)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sha = hashlib.sha256(blob).hexdigest()
    if sha != main_info["blob_sha256"]:
        fail(f"stream_path: blob sha256 {sha} is not main_path's "
             f"{main_info['blob_sha256']}")
    if loader.faults != [0, 2] or sleeps != [0.1, 0.1]:
        fail(f"stream_path: faults in chunks() calls {loader.faults}, backoffs "
             f"{sleeps}; expected one fault a pass and [0.1, 0.1]")
    nrmse = rep.per_species_nrmse
    if not (nrmse <= target * (1 + 1e-3)).all():
        fail(f"stream_path: normalized-vector NRMSE {nrmse.max():.4e} > {target}")
    if counts["gbatc_project_batched"] != 1 or counts["gbatc_select_accumulate"] != 1:
        fail(f"stream_path: fit_stream + compress launched {counts}; expected one "
             "projection and one select")
    timings = json.loads(json.dumps(gb.pipeline.timings))
    del gb, rep, blob

    # -- the QoI on the card against the host ------------------------------
    mech = qoi.make_mechanism(data.shape[0])
    out = {}
    for name, y in (("field", data), ("decoded", field)):
        t0 = time.perf_counter()
        q_dev = qoi.production_rates_np(mech, y, temperature)
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        q_host = qoi.production_rates_np(mech, y, temperature, device="cpu")
        host_s = time.perf_counter() - t0
        fin = np.isfinite(q_host)
        if not np.array_equal(fin, np.isfinite(q_dev)):
            fail(f"stream_path: QoI of the {name}: card and host disagree on "
                 "which rates are finite")
        scale = np.where(fin, np.abs(q_host), 0).max(axis=(1, 2, 3))
        err = np.where(fin, np.abs(q_dev - q_host), 0).max(axis=(1, 2, 3))
        worst = float((err / np.maximum(scale, 1e-300)).max())
        if worst > QOI_RTOL:
            fail(f"stream_path: QoI of the {name} on the card is {worst:.3e} of a "
                 f"species' largest rate from the host's (limit {QOI_RTOL})")
        out[name] = {"q": q_dev, "card_s": dev_s, "host_s": host_s,
                     "max_err_over_species_max": worst,
                     "non_finite": int((~fin).sum())}
    q_nrmse = np.array([metrics.nrmse(out["field"]["q"][s], out["decoded"]["q"][s])
                        for s in range(data.shape[0])])
    info = {
        "phase": "stream_path", "shape": list(data.shape), "chunk_frames": 4,
        "faults_in_chunks_calls": loader.faults, "backoffs_s": sleeps,
        "fit_s": fit_s, "fit_and_compress_s": total_s,
        "timings_s": timings,
        "blob_sha256": sha, "blob_equals_main_path": True,
        "max_nrmse_normalized": float(nrmse.max()), "target_nrmse": target,
        "peak_device_gb": peak_gb, "launches": counts,
        "qoi": {"reactions": int(mech.nu_fwd.shape[1]), "rtol": QOI_RTOL,
                **{k: {kk: vv for kk, vv in v.items() if kk != "q"}
                   for k, v in out.items()},
                "nrmse_decoded": {"max": float(np.nanmax(q_nrmse)),
                                  "median": float(np.nanmedian(q_nrmse)),
                                  "per_species": [float(x) for x in q_nrmse]}},
        "seconds": time.perf_counter() - t_start,
    }
    emit(info)
    return info


MESH_P = 4  # mesh_path's data-parallel width
MESH_SHARDS = (4, 116)  # sharded-engine chunk counts: species only; rows split


def mesh_of(torch, k: int):
    """``host_mesh(k)`` on a machine with k cards, else ``(cuda:0,) * k``:
    every P > 1 branch of the port then runs on one card."""
    from repro_torch.parallel import Mesh, host_mesh

    if torch.cuda.device_count() >= k:
        return host_mesh(k), f"host_mesh({k})"
    return Mesh((torch.device("cuda", 0),) * k), f"(cuda:0,) * {k}"


class DPRecorder:
    """Wraps ``mesh_fit.dp_fit`` while a phase drives the pipeline: records
    each data-parallel fit's losses and whether its replicas came out
    bitwise equal (``dp_fit`` itself raises when they do not)."""

    def __init__(self, torch):
        from repro_torch.parallel import mesh_fit

        self.torch, self.mesh_fit, self.fits = torch, mesh_fit, []

    def __enter__(self):
        self.real = real = self.mesh_fit.dp_fit

        def recorded(*a, **kw):
            replicas, losses = real(*a, **kw)
            self.fits.append({"replicas": len(replicas), "losses": losses,
                              "replicas_equal": replicas_equal(self.torch, replicas)})
            return replicas, losses

        self.mesh_fit.dp_fit = recorded
        return self

    def __exit__(self, *exc):
        self.mesh_fit.dp_fit = self.real
        return False


def replicas_equal(torch, replicas) -> bool:
    first = replicas[0]
    return all(torch.equal(r[name].to(first[name].device), first[name])
               for r in replicas[1:] for name in r)


def falling(losses, what: str, phase: str = "mesh_path") -> dict:
    """Finite losses whose last tenth's mean is below the first tenth's."""
    import numpy as np

    tenth = max(1, len(losses) // 10)
    first, last = float(np.mean(losses[:tenth])), float(np.mean(losses[-tenth:]))
    if not (np.isfinite(losses).all() and last < first):
        fail(f"{phase}: {what}: losses not finite and falling "
             f"(first tenth {first:.4e}, last tenth {last:.4e})")
    return {"steps": len(losses), "first_tenth_mean": first,
            "last_tenth_mean": last, "final": float(losses[-1])}


def phase_mesh_path(torch, args, main_info: dict, data, main_codec) -> dict:
    """The mesh-sharded fit and compress on the card (no new kernel), on
    main_path's field, fitted codec and blob sha256:

    1. main_path's fitted state compressed at 1e-3 through
       ``ShardedGuaranteeEngine(n_shards=4)`` and ``(n_shards=116)`` (rows
       split): each blob main_path's byte for byte, k projection and k select
       launches; the peak device memory of each against the default
       engine's on the same decode + prepare + select;
    2. ``fit_stream`` on a 1-device mesh: main_path's blob;
    3. the P-wide DP fit through ``GBATCCodec(mesh=...)`` (fp32 exchange):
       replicas bitwise equal, losses falling, the bound met on every
       species, latents bitwise the one-device encode, decompress bitwise
       the report's reconstruction;
    4. ``MiniBatchTrainer.fit(mesh=..., quantized_exchange=True)`` on the
       conv AE's loss over main_path's blocks: replicas bitwise equal,
       losses falling, ``block_quant`` launched P times a step, a sampled
       bucket's launch bitwise its plain version; the bucket's kernel time
       against its plain version and bound.

    Launch counts are reset just before each part and read just after."""
    import numpy as np

    from repro_torch import codec
    from repro_torch.core import autoencoder, blocking, gae
    from repro_torch.core.pipeline import GBATCCodec, GBATCPipeline
    from repro_torch.data import s3d
    from repro_torch.kernels import block_quant as bk
    from repro_torch.kernels import ref as kref
    from repro_torch.parallel import gradient_compression as gc
    from repro_torch.parallel import host_mesh, mesh_fit, shard_rows
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop

    t_start = time.perf_counter()
    target = 1e-3
    cfg = main_config(args)
    sha = main_info["blob_sha256"]
    mesh, mesh_kind = mesh_of(torch, MESH_P)
    launches, info = {}, {"phase": "mesh_path", "P": MESH_P, "mesh": mesh_kind,
                          "devices": [str(d) for d in mesh.devices]}

    def peak_over(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, seconds, counts = counted(torch, fn)
        return out, seconds, counts, (torch.cuda.max_memory_allocated() - base) / 1e9

    # -- 1. the sharded engine on main_path's fitted state -----------------
    # the engines alone (prepare + select) on the compress's own inputs,
    # then each sharded engine through the whole compress
    pipe = main_codec.pipeline
    pipe.set_guarantee_engine(gae.default_engine())
    prep = pipe._prepare_guarantee(0.05, False)[0]
    x, x_rec = prep.x_ref, prep.x_rec32
    del prep
    pipe.set_guarantee_engine(gae.default_engine())
    tau = target * np.sqrt(cfg.geometry.block_size)
    engines = {}
    for n in (None,) + MESH_SHARDS:
        eng = (gae.default_engine() if n is None
               else mesh_fit.ShardedGuaranteeEngine(mesh=mesh, n_shards=n))
        _, seconds, _, peak = peak_over(lambda: eng.select(eng.prepare(x, x_rec), tau))
        engines["default" if n is None else f"n_shards_{n}"] = {
            "prepare_select_s": seconds, "prepare_select_peak_device_gb": peak}
    del x, x_rec
    for n in MESH_SHARDS:
        pipe.set_guarantee_engine(mesh_fit.ShardedGuaranteeEngine(mesh=mesh, n_shards=n))
        chunks = len(mesh_fit._chunk_plan(pipe.n_species, pipe._latents.shape[0], n))
        blob, seconds, counts, peak = peak_over(
            lambda: main_codec.compress(target_nrmse=target))
        got = hashlib.sha256(blob).hexdigest()
        if got != sha:
            fail(f"mesh_path: n_shards={n} blob sha256 {got} is not main_path's {sha}")
        for kernel in ("gbatc_project_batched", "gbatc_select_accumulate"):
            if counts[kernel] != chunks:
                fail(f"mesh_path: n_shards={n}: {kernel} launched {counts[kernel]} "
                     f"times, expected one a chunk ({chunks})")
        launches[f"engine_{n}"] = counts
        engines[f"n_shards_{n}"].update(
            chunks=chunks, compress_s=seconds, compress_peak_device_gb=peak,
            timings_s=json.loads(json.dumps(pipe.timings)),
            blob_equals_main_path=True)
    pipe.set_guarantee_engine(gae.default_engine())
    info["sharded_engine"] = engines

    # -- 2. mesh ingest on a 1-device mesh ---------------------------------
    loader = s3d.S3DChunkLoader(s3d_config(args), chunk_frames=4)
    (blob, rep), seconds, counts = counted(torch, lambda: (
        GBATCCodec(cfg, mesh=host_mesh(1)).fit_stream(loader)
        .compress_report(target_nrmse=target)))
    got = hashlib.sha256(blob).hexdigest()
    if got != sha:
        fail(f"mesh_path: fit_stream on a 1-device mesh gave blob {got}, "
             f"not main_path's {sha}")
    launches["fit_stream_p1"] = counts
    info["fit_stream_p1"] = {"seconds": seconds, "blob_equals_main_path": True}
    del blob, rep

    # -- 3. the P-wide DP fit through the pipeline (fp32 exchange) ---------
    gb = GBATCCodec(cfg, mesh=mesh)
    with DPRecorder(torch) as rec:
        _, fit_s, fit_counts = counted(torch, lambda: gb.fit(data))
    dp = gb.pipeline
    if [f["replicas"] for f in rec.fits] != [MESH_P, MESH_P]:
        fail(f"mesh_path: the pipeline ran {len(rec.fits)} data-parallel fits "
             f"({[f['replicas'] for f in rec.fits]} replicas); expected the AE "
             f"and the correction at P={MESH_P}")
    if not all(f["replicas_equal"] for f in rec.fits):
        fail("mesh_path: the pipeline's DP fit left unequal replicas")
    fits = {name: falling(f["losses"], f"pipeline {name} fit")
            for name, f in zip(("ae", "correction"), rec.fits)}
    shards = dp._block_shards
    one_device = GBATCPipeline._encode(
        dp, dp._ae_params, torch.cat([s.to(mesh.devices[0]) for s in shards]))
    if not np.array_equal(one_device, dp._latents):
        fail("mesh_path: the sharded encode's latents are not the one-device "
             "encode's bitwise")
    (blob, rep), compress_s, compress_counts = counted(
        torch, lambda: gb.compress_report(target_nrmse=target))
    nrmse = rep.per_species_nrmse
    if not (nrmse <= target * (1 + 1e-3)).all():
        fail(f"mesh_path: DP fit compress missed the bound: {nrmse.max():.4e}")
    field, decompress_s, decompress_counts = counted(torch, lambda: codec.decompress(blob))
    if not np.array_equal(field, rep.recon):
        fail("mesh_path: decompress(blob) of the DP fit is not the encode "
             "side's reconstruction")
    launches.update(dp_fit=fit_counts, dp_compress=compress_counts,
                    dp_decompress=decompress_counts)
    info["dp_fit"] = {
        "fit_s": fit_s, "compress_s": compress_s, "decompress_s": decompress_s,
        "timings_s": json.loads(json.dumps(dp.timings)),
        "losses": fits, "replicas_bitwise_equal": True,
        "latents_equal_one_device": True, "decode_bitwise": True,
        "max_nrmse": float(nrmse.max()), "target_nrmse": target,
        "compression_ratio": rep.compression_ratio, "blob_bytes": len(blob),
        "blob_sha256": hashlib.sha256(blob).hexdigest()}
    del gb, dp, blob, rep, field, shards

    # -- 4. the int8 exchange: the conv AE's loss over main_path's blocks --
    normed, _, _ = GBATCPipeline._normalize(data)
    blocks = blocking.to_blocks(normed, cfg.geometry)
    del normed
    model = pipe.model
    trainer = train_loop.MiniBatchTrainer(autoencoder.ae_loss(model),
                                          opt.adamw_cfg(cfg.lr, cfg.ae_steps))
    params = autoencoder.init_params(model.cfg, cfg.seed, mesh.devices[0])
    block_shards = shard_rows(blocks, mesh)
    sample_at = MESH_P * (cfg.ae_steps // 2)  # a bucket halfway through
    sampled, calls = {}, [0]
    real_bq = gc._block_quant

    def sampling(xb, n_bits, block):
        out = real_bq(xb, n_bits, block)
        if calls[0] == sample_at:
            sampled.update(x=xb.clone(), values=out[0].clone(), scales=out[1].clone(),
                           n_bits=n_bits, block=block)
        calls[0] += 1
        return out

    gc._block_quant = sampling
    try:
        (_, losses), q_fit_s, q_counts = counted(torch, lambda: trainer.fit(
            params, (block_shards,), steps=cfg.ae_steps, batch_size=cfg.batch_size,
            seed=cfg.seed, mesh=mesh, quantized_exchange=True))
    finally:
        gc._block_quant = real_bq
    if not replicas_equal(torch, trainer.last_replicas):
        fail("mesh_path: the int8-exchange fit left unequal replicas")
    q_loss = falling(losses, "int8-exchange fit")
    if q_counts["block_quant"] != MESH_P * cfg.ae_steps:
        fail(f"mesh_path: block_quant launched {q_counts['block_quant']} times in "
             f"{cfg.ae_steps} steps at P={MESH_P}; expected one a shard a step")
    xb = sampled["x"]
    want, want_sc = kref.block_quant_ref(xb, n_bits=sampled["n_bits"],
                                         block=sampled["block"])
    if not (torch.equal(sampled["values"], want)
            and torch.equal(sampled["scales"], want_sc.reshape(-1))):
        fail("mesh_path: the sampled gradient bucket's block_quant launch is not "
             "bitwise its plain version")
    launches["int8_exchange_fit"] = q_counts
    n_vals = xb.numel()
    nbytes = 2 * 4 * n_vals + 4 * xb.shape[0]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    reps = max(20, args.launches)
    bucket = {
        "shape": list(xb.shape), "n_bits": sampled["n_bits"], "sampled_call": sample_at,
        "bitwise_plain": True,
        "ms": time_ms(torch, lambda: bk.block_quant(xb, n_bits=8, block=64), reps),
        "device_ms": device_ms(torch, lambda: bk.block_quant(xb, n_bits=8, block=64)),
        "plain_ms": time_ms(torch, lambda: kref.block_quant_ref(xb, n_bits=8, block=64),
                            reps),
        "plain_device_ms": device_ms(
            torch, lambda: kref.block_quant_ref(xb, n_bits=8, block=64)),
        "bound_ms": t_bytes, "bound_by": "bytes", "bytes": nbytes}
    info["int8_exchange"] = {
        "fit_s": q_fit_s, "losses": q_loss,
        "fp32_exchange_final_loss": fits["ae"]["final"],
        "replicas_bitwise_equal": True, "block_quant_launches": q_counts["block_quant"],
        "bucket": bucket,
        "dp_wire_report": mesh_fit.dp_wire_report(params, MESH_P),
    }
    info["launches"] = launches
    info["seconds"] = time.perf_counter() - t_start
    emit(info)
    return info


# -- the language-model serving path (lm_serve_path) -------------------------
# flash attention at the prefill shapes of the LM configs (B, H, Tq, Tk, D,
# causal, window), heads already expanded, at batch 4 and prompt 2304:
# Llama-3.2-1B's self-attention (D = 64), StableLM-3B's (D = 80: the DP = 128
# instantiation with 48 zero-padded dims), Yi-9B's (D = 128; Qwen3-MoE,
# Qwen2-72B and DBRX run this shape with 32, 64 and 48 heads), Qwen2-VL-7B's
# (28 heads over the prompt and its 256 patches), RecurrentGemma-2B's local
# MQA (head dim 256, window 2048), and Whisper-base's encoder, decoder self-
# and cross-attention
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2304, 16
LM_VLM_T = LM_PROMPT + 256  # Qwen2-VL-7B's n_patches
LM_FLASH_SHAPES = {
    "llama3_2_1b": (LM_BATCH, 32, LM_PROMPT, LM_PROMPT, 64, True, 0),
    "stablelm_3b": (LM_BATCH, 32, LM_PROMPT, LM_PROMPT, 80, True, 0),
    "yi_9b": (LM_BATCH, 32, LM_PROMPT, LM_PROMPT, 128, True, 0),
    "qwen2_vl_7b": (LM_BATCH, 28, LM_VLM_T, LM_VLM_T, 128, True, 0),
    "recurrentgemma_2b": (LM_BATCH, 10, LM_PROMPT, LM_PROMPT, 256, True, 2048),
    "whisper_base.encoder": (LM_BATCH, 8, 1500, 1500, 64, False, 0),
    "whisper_base.decoder_self": (LM_BATCH, 8, LM_PROMPT, LM_PROMPT, 64, True, 0),
    "whisper_base.decoder_cross": (LM_BATCH, 8, LM_PROMPT, 1500, 64, False, 0),
}
LM_RWKV = (LM_BATCH, LM_PROMPT, 64, 64)  # RWKV-6 7B's 64 heads of 64
LM_RGLRU = (LM_BATCH, LM_PROMPT, 2560)   # RecurrentGemma-2B's rglru_width
# bf16 at these shapes: within FLASH_LIMIT and bf16_ulp_ratio <= 1, like
# every bf16 entry of FLASH_SHAPES, and faster than its plain version
# step 2: kernel route against portable route in fp32, batch 2 and a prompt
# that crosses RecurrentGemma's 2048 window (ring buffer + window mask);
# StableLM-3B for partial RoPE at D = 80, Yi-9B for GQA at D = 128
LM_CHECK_ARCHS = ("llama3_2_1b", "stablelm_3b", "yi_9b", "rwkv6_7b",
                  "recurrentgemma_2b", "whisper_base")
LM_CHECK_BATCH, LM_CHECK_PROMPT, LM_CHECK_STEPS = 2, 2112, 4
LM_ROUTE_LIMIT = 1e-3  # max |kernel - portable| over max |portable logit|
LM_CONSISTENCY = 2e-2  # tests/test_models_smoke.py's rtol = atol
# step 3: bf16 serving at full width; depth cut where the bf16 weights would
# not fit in about 20 GB
LM_SERVE_LAYERS = {"qwen3_moe_30b_a3b": 8, "qwen2_72b": 8, "dbrx_132b": 2}
LM_KV_QUANT = ("qwen3_moe_30b_a3b", "dbrx_132b")


def flash_pairs(tq: int, tk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep: the work flash attention needs."""
    total = 0
    for q in range(tq):
        hi = min(tk, q + 1) if causal else tk
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def expected_prefill_launches(cfg) -> dict:
    """Launches of each kernel in one prefill with ``use_kernels``."""
    out = {"flash_attention": 0, "rwkv6_scan": 0, "rglru_scan": 0}
    if cfg.family == "ssm":
        out["rwkv6_scan"] = cfg.n_layers
    elif cfg.family == "hybrid":
        periods = cfg.n_layers // 3
        out["flash_attention"] = periods
        out["rglru_scan"] = 2 * periods + cfg.n_layers - 3 * periods
    elif cfg.family == "audio":
        out["flash_attention"] = cfg.n_encoder_layers + 2 * cfg.n_layers
    else:
        out["flash_attention"] = cfg.n_layers
    return out


def counts_are(what: str, want: dict, totals: dict,
               phase: str = "lm_serve_path") -> dict:
    """The launch counts since the last reset are ``want`` (0 elsewhere);
    adds them to ``totals``."""
    got = all_counts()
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        fail(f"{phase}: {what} launched {got}, expected {full}")
    for k, n in got.items():
        totals[k] += n
    return got


def staging_bytes(cfg, b: int, t: int) -> int:
    """Bytes the copies around the flash calls of one prefill write: q and
    the output to and from (B, H, T, D), K and V repeated to H heads (a
    copy where Hkv < H) and made contiguous."""
    item, d = cfg.dtype.itemsize, cfg.head_dim
    rep = 2 if cfg.n_kv_heads < cfg.n_heads else 1

    def call(tq, tk, h):
        return item * b * h * d * (2 * tq + 2 * rep * tk)

    if cfg.family == "audio":
        a = cfg.n_audio_ctx
        return (cfg.n_encoder_layers * call(a, a, cfg.n_heads)
                + cfg.n_layers * (call(t, t, cfg.n_heads) + call(t, a, cfg.n_heads)))
    calls = expected_prefill_launches(cfg)["flash_attention"]
    return calls * call(t, t, cfg.n_heads)


def sdpa_backend(torch, q, k, v, **kw) -> str:
    """Which backend scaled_dot_product_attention picks for these inputs."""
    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "unknown"
    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(choose(q, k, v, **kw)).name
    except (ImportError, ValueError, RuntimeError) as e:
        return f"unknown ({type(e).__name__})"


def phase_lm_kernels(torch, launches: int) -> dict:
    """flash_attention, rwkv6_scan and rglru_scan against their plain
    versions at lm_serve_path's shapes: fp32 at each kernel's limit, bf16
    where the model runs bf16, each timed beside its bound, its plain
    version and (flash) SDPA at the same dtype. Returns {kernel: [entries]}."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import rglru_scan as rk
    from repro_torch.kernels import rwkv6_scan as wk

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(700)
    t_start = time.perf_counter()
    out = {"flash_attention": [], "rwkv6_scan": [], "rglru_scan": []}

    def entry(fn, plain, lib, dtype, shape, nbytes, flops, err, **extra):
        row = kernel_row(torch, "", "", "", fn, plain, lib, dtype, shape, nbytes,
                         flops, launches, err, **extra)
        for key in ("name", "route", "source", "replaces", "launches"):
            row.pop(key)
        return row

    for name, (b, h, tq, tk, d, causal, window) in LM_FLASH_SHAPES.items():
        pairs = b * h * flash_pairs(tq, tk, causal, window)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q = torch.randn(b, h, tq, d, generator=g, device="cuda").to(dtype)
            k, v = (torch.randn(b, h, tk, d, generator=g, device="cuda").to(dtype)
                    for _ in range(2))
            fn = lambda: fk.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
            plain = lambda: kref.flash_attention_ref(q, k, v, causal=causal,  # noqa: E731
                                                     window=window)
            got, want = fn(), plain()
            if got.dtype != dtype or not torch.isfinite(got).all():
                fail(f"flash_attention at {name} returned {got.dtype} or non-finite values")
            diff = (got.float() - want.float()).abs()
            errs[dn] = float(diff.max())
            scale = {"plain_max_abs": float(want.float().abs().max()),
                     "plain_mean_abs": float(want.float().abs().mean())}
            if dtype == torch.bfloat16:
                scale["bf16_ulp_ratio"] = bf16_ulp_ratio(diff, want)
            if errs[dn] > FLASH_LIMIT[dn] or scale.get("bf16_ulp_ratio", 0.0) > 1.0:
                fail(f"flash_attention differs from its plain version at {name} "
                     f"({dn}): {errs[dn]:.3e} (limit {FLASH_LIMIT[dn]}), {scale}")
            del got, want, diff
            if d in (80, 256):  # padded dims and the widest instantiation:
                # same bits twice, and per batch row
                same_twice(torch, f"flash_attention D={d} {dn}", fn)
                same_rows(torch, f"flash_attention D={d} {dn}", fn(),
                          [(slice(1, 3), fk.flash_attention(
                              q[1:3].contiguous(), k[1:3].contiguous(),
                              v[1:3].contiguous(), causal=causal, window=window))])
            # the library yardstick: SDPA at the same dtype; the window as a
            # boolean mask (SDPA has no window argument)
            mask = None
            if window > 0:
                qi = torch.arange(tq, device="cuda")[:, None]
                ki = torch.arange(tk, device="cuda")[None, :]
                mask = (ki <= qi) & (ki > qi - window)
            sdpa_kw = ({"attn_mask": mask} if mask is not None
                       else {"is_causal": causal})
            lib = lambda: F.scaled_dot_product_attention(q, k, v, **sdpa_kw)  # noqa: E731
            row = entry(
                fn, plain, lib, dn, (b, h, tq, tk, d), 2 * b * h * (tq + tk) * d * dtype.itemsize,
                4 * pairs * d, errs[dn], config=name, causal=causal, window=window,
                live_pairs=pairs, library_backend=sdpa_backend(torch, q, k, v, **sdpa_kw),
                library_max_abs_err=float((lib().float() - plain().float()).abs().max()),
                **scale,
                tolerance=(f"max abs diff <= {FLASH_LIMIT[dn]}" + (
                    f" and |diff| <= 2^-7 |plain| + {2 * FLASH_LIMIT['float32']}"
                    " at every element; ms < plain_ms" if dtype == torch.bfloat16
                    else "")))
            out["flash_attention"].append(row)
            if dtype == torch.bfloat16 and row["ms"] >= row["plain_ms"]:
                fail(f"flash_attention bf16 at {name}: {row['ms']:.3f} ms, not faster "
                     f"than its plain version ({row['plain_ms']:.3f} ms)")
            del q, k, v, mask
            torch.cuda.empty_cache()

    b, t, h, n = LM_RWKV
    r, k, v = (torch.randn(b, t, h, n, generator=g, device="cuda") for _ in range(3))
    w = torch.sigmoid(3.0 + torch.randn(b, t, h, n, generator=g, device="cuda"))
    u = 0.5 * torch.randn(h, n, generator=g, device="cuda")
    s0 = torch.randn(b, h, n, n, generator=g, device="cuda")
    args = (r, k, v, w, u, s0)
    got, got_s = wk.rwkv6_scan(*args)
    want, want_s = kref.rwkv6_scan_ref(*args)
    err = max(float((got - want).abs().max()), float((got_s - want_s).abs().max()))
    top = max(1.0, float(want.abs().max()), float(want_s.abs().max()))
    if not (torch.isfinite(got).all() and err <= RWKV_LIMIT * top):
        fail(f"rwkv6_scan differs from its plain version at {LM_RWKV}: {err:.3e}")
    same_twice(torch, "rwkv6_scan (lm shape)", lambda: wk.rwkv6_scan(*args))
    tokens = b * t * h
    out["rwkv6_scan"].append(entry(
        lambda: wk.rwkv6_scan(*args), lambda: kref.rwkv6_scan_ref(*args), None,
        "float32", LM_RWKV, 5 * tokens * n * 4 + 2 * b * h * n * n * 4 + h * n * 4,
        5 * tokens * n * n, err, plain_launches=3, config="rwkv6_7b",
        initial_state="random (B,H,N,N)",
        tolerance="max abs diff <= 2e-4 x max(1, max|plain|)"))
    del r, k, v, w, u, s0, args, got, got_s, want, want_s

    b, t, wd = LM_RGLRU
    a = torch.sigmoid(2.0 + torch.randn(b, t, wd, generator=g, device="cuda"))
    bb = torch.randn(b, t, wd, generator=g, device="cuda")
    h0 = torch.randn(b, wd, generator=g, device="cuda")
    got, got_h = rk.rglru_scan(a, bb, h0)
    want, want_h = kref.rglru_scan_ref(a, bb, h0)
    err = max(float((got - want).abs().max()), float((got_h - want_h).abs().max()))
    if not (torch.isfinite(got).all() and err <= RGLRU_LIMIT):
        fail(f"rglru_scan differs from its plain version at {LM_RGLRU}: {err:.3e}")
    nel = b * t * wd
    out["rglru_scan"].append(entry(
        lambda: rk.rglru_scan(a, bb, h0), lambda: kref.rglru_scan_ref(a, bb, h0),
        None, "float32", LM_RGLRU, 3 * nel * 4 + 2 * b * wd * 4, 2 * nel, err,
        plain_launches=3, config="recurrentgemma_2b",
        tolerance="max abs diff <= 1e-5 at unit-scale inputs"))
    del a, bb, h0, got, got_h, want, want_h
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "lm_serve_shapes", "launches_timed": launches,
          "seconds": time.perf_counter() - t_start,
          "summary": {name: [{k: e[k] for k in ("shape", "dtype", "max_abs_err",
                                                 "bf16_ulp_ratio", "plain_max_abs",
                                                 "plain_mean_abs", "ms", "plain_ms",
                                                 "library_ms", "bound_ms", "bound_by")
                              if k in e}
                             for e in entries] for name, entries in out.items()}})
    return out


def _logit_gap(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def lm_route_check(torch, arch: str, totals: dict) -> dict:
    """Step 2 for one config: fp32 under strict_fp32, full width and depth,
    one seed's parameters through use_kernels=True and =False."""
    from repro_torch.configs.base import get_config
    from repro_torch.device import strict_fp32
    from repro_torch.models.registry import build_model, make_batch

    cfg = get_config(arch).replace(dtype=torch.float32)
    kern, port = build_model(cfg), build_model(cfg.replace(use_kernels=False))
    t0 = time.perf_counter()
    params = kern.init(seed=0, device="cuda")
    full = make_batch(cfg, batch=LM_CHECK_BATCH, seq=LM_CHECK_PROMPT + 1,
                      kind="prefill", seed=11, device="cuda")
    pre = {k: (v[:, :LM_CHECK_PROMPT] if k == "tokens" else v) for k, v in full.items()}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    info = {"init_s": init_s}
    with strict_fp32():
        reset_counts()
        t0 = time.perf_counter()
        lk, ck = kern.prefill(params, pre)
        torch.cuda.synchronize()
        info["prefill_kernel_s"] = time.perf_counter() - t0
        info["prefill_launches"] = counts_are(
            f"{arch} fp32 prefill", expected_prefill_launches(cfg), totals)
        reset_counts()
        t0 = time.perf_counter()
        lp, cp = port.prefill(params, pre)
        torch.cuda.synchronize()
        info["prefill_portable_s"] = time.perf_counter() - t0
        counts_are(f"{arch} portable prefill", {}, totals)
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            fail(f"lm_serve_path: {arch} fp32 prefill logits are not finite")
        gaps = [_logit_gap(lk, lp)]
        # four decode steps on each route's own cache, fed the same tokens:
        # the prompt's next token, then the kernel route's greedy picks
        tok = full["tokens"][:, LM_CHECK_PROMPT:]
        agree = []
        reset_counts()
        for step in range(LM_CHECK_STEPS):
            dk, ck = kern.decode_step(params, ck, tok)
            dp, cp = port.decode_step(params, cp, tok)
            if step == 0:
                first = dk
            gaps.append(_logit_gap(dk, dp))
            agree.append(bool(torch.equal(dk.argmax(-1), dp.argmax(-1))))
            tok = dk[:, -1:].argmax(-1).to(torch.int32)
        counts_are(f"{arch} decode steps", {}, totals)
        reset_counts()
        lf, _ = kern.prefill(params, full)
        counts_are(f"{arch} fp32 prefill(T+1)", expected_prefill_launches(cfg), totals)
        consistency = float((first.float() - lf.float()).abs().max())
        scale = float(lf.float().abs().max())
    info.update(route_gap_prefill=gaps[0], route_gap_decode=gaps[1:],
                route_limit=LM_ROUTE_LIMIT, greedy_agree=agree,
                max_abs_logit=scale,
                prefill_decode_max_abs=consistency,
                prefill_decode_limit=f"atol {LM_CONSISTENCY} + rtol {LM_CONSISTENCY}")
    if max(gaps) > LM_ROUTE_LIMIT:
        fail(f"lm_serve_path: {arch} fp32 kernel route differs from the portable "
             f"route by {max(gaps):.3e} of the largest logit (limit {LM_ROUTE_LIMIT})")
    if not torch.allclose(first.float(), lf.float(), rtol=LM_CONSISTENCY,
                          atol=LM_CONSISTENCY):
        fail(f"lm_serve_path: {arch} prefill(T) + decode_step differs from "
             f"prefill(T+1) by {consistency:.3e}")
    del ck, cp, lk, lf, first
    info["bf16"] = lm_route_check_bf16(torch, cfg, params, lp, totals)
    return info


def lm_route_check_bf16(torch, cfg, params, lp, totals) -> dict:
    """The bf16 routes against fp32 (C-check-4): ``params`` (fp32, the
    route check's) cast to each leaf's bf16-model dtype, which is what the
    bf16 model's own init gives (it draws in fp32 and casts), the route
    check's batch, one prefill through the kernel route and one through the
    portable route (each after a warm-up), both held against the fp32
    portable logits ``lp``. The kernel route must be no farther from fp32
    than twice the portable bf16 route is. Frees ``params``."""
    from repro_torch.models.registry import build_model, make_batch

    arch = cfg.name
    cfg16 = cfg.replace(dtype=torch.bfloat16)
    kern = build_model(cfg16)
    port = build_model(cfg16.replace(use_kernels=False))
    specs = kern.specs()
    params16 = {k: params.pop(k).to(specs[k].dtype) for k in list(params)}
    torch.cuda.empty_cache()
    pre = {k: (v[:, :LM_CHECK_PROMPT] if k == "tokens" else v)
           for k, v in make_batch(cfg16, batch=LM_CHECK_BATCH, seq=LM_CHECK_PROMPT + 1,
                                  kind="prefill", seed=11, device="cuda").items()}
    out, logits = {}, {}
    for route, model, want in (("kernel", kern, expected_prefill_launches(cfg)),
                               ("portable", port, {})):
        for _ in range(2):  # warm-up, then the timed prefill
            logits.pop(route, None)
            reset_counts()
            t0 = time.perf_counter()
            logits[route], _ = model.prefill(params16, pre)
            torch.cuda.synchronize()
            out[f"prefill_{route}_s"] = time.perf_counter() - t0
            counts_are(f"{arch} bf16 {route} prefill", want, totals)
        if not torch.isfinite(logits[route]).all():
            fail(f"lm_serve_path: {arch} bf16 {route} prefill logits are not finite")
    lk, lq = logits["kernel"], logits["portable"]
    last = {name: t[:, -1].argmax(-1) for name, t in
            (("kernel", lk), ("portable", lq), ("fp32", lp))}
    out.update(
        gap_kernel_fp32=_logit_gap(lk, lp), gap_portable_fp32=_logit_gap(lq, lp),
        gap_kernel_portable=_logit_gap(lk, lq),
        greedy_agree_last={
            "kernel_portable": float((last["kernel"] == last["portable"]).float().mean()),
            "kernel_fp32": float((last["kernel"] == last["fp32"]).float().mean()),
            "portable_fp32": float((last["portable"] == last["fp32"]).float().mean())},
        limit="gap_kernel_fp32 <= 2 gap_portable_fp32")
    del params16, logits, lk, lq, lp
    torch.cuda.empty_cache()
    if out["gap_kernel_fp32"] > 2 * out["gap_portable_fp32"]:
        fail(f"lm_serve_path: {arch} bf16 kernel route is {out['gap_kernel_fp32']:.3e} "
             f"of the largest logit from fp32, more than twice the portable bf16 "
             f"route's {out['gap_portable_fp32']:.3e}")
    return out


GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")  # cuBLAS / cuBLASLt kernels


def device_breakdown(torch, fn) -> dict:
    """``fn()`` once under ``torch.profiler``: its wall seconds (ending in a
    synchronise), the device time of its kernels by group (the three
    kernels of the path, cuBLAS GEMMs, everything else), and the device's
    idle share of the wall time; "not measured" where the profiler saw no
    device activity. The profiler's own host cost inflates the wall time
    (and so the idle share) of host-bound work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {"flash_attention": 0.0, "rwkv6_scan": 0.0, "rglru_scan": 0.0,
              "gemm": 0.0, "other": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        key = next((k for k, tags in (("flash_attention", ("flash_kernel",
                                                           "flash_bf16_mma")),
                                      ("rwkv6_scan", ("rwkv6_kernel",)),
                                      ("rglru_scan", ("rglru_kernel",)))
                    if any(tag in name for tag in tags)),
                   "gemm" if any(g in name for g in GEMM_NAMES) else "other")
        groups[key] += e.time_range.elapsed_us() / 1e6
        n += 1
    if not n:
        return {"wall_s": wall, "device_s": "not measured"}
    busy = sum(groups.values())
    return {"wall_s": wall, "device_s": busy, "device_idle_share": max(0.0, 1 - busy / wall),
            "by_kernel_s": groups, "device_events": n}


def lm_serve(torch, arch: str, totals: dict) -> dict:
    """Step 3 for one config: bf16 Server, greedy, batch 4, prompt 2304, 16
    new tokens, at full width (depth cut per LM_SERVE_LAYERS)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.serve import Server

    cfg = get_config(arch)
    full_layers = cfg.n_layers
    if arch in LM_SERVE_LAYERS:
        cfg = cfg.replace(n_layers=LM_SERVE_LAYERS[arch])
    model = build_model(cfg)
    param_bytes = sum(t.numel() * t.element_size() for t in model.specs().values())
    want = expected_prefill_launches(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    batch = make_batch(cfg, batch=LM_BATCH, seq=LM_PROMPT, kind="prefill", seed=12,
                       device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the peak of the serving runs alone (init draws in fp32 scratch)
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    prompt_total = LM_PROMPT + (cfg.n_patches if cfg.is_vlm else 0)
    max_len = prompt_total + LM_NEW + 8  # room for the patches too
    server = Server(model, params, max_len=max_len, device="cuda")
    # warm-up + gates: prefill logits finite, exact launch counts
    reset_counts()
    logits, _ = model.prefill(params, batch, max_len=max_len)
    torch.cuda.synchronize()
    counts_are(f"{arch} bf16 prefill", want, totals)
    if not torch.isfinite(logits).all():
        fail(f"lm_serve_path: {arch} bf16 prefill logits are not finite")
    del logits
    reset_counts()
    t0 = time.perf_counter()
    logits, _ = model.prefill(params, batch, max_len=max_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts_are(f"{arch} bf16 prefill (timed)", want, totals)
    del logits
    # where the time goes: one prefill and LM_CHECK_STEPS decode steps
    # under the profiler (launch counts as everywhere else)
    reset_counts()
    prefill_prof = device_breakdown(
        torch, lambda: model.prefill(params, batch, max_len=max_len))
    _, cache = model.prefill(params, batch, max_len=max_len)
    counts_are(f"{arch} bf16 prefills (profiled)", {k: 2 * n for k, n in want.items()},
               totals)
    tok = batch["tokens"][:, -1:]

    def steps():
        c = cache
        for _ in range(LM_CHECK_STEPS):
            _, c = model.decode_step(params, c, tok)

    reset_counts()
    decode_prof = device_breakdown(torch, steps)
    counts_are(f"{arch} bf16 decode steps (profiled)", {}, totals)
    del cache
    runs = []
    for _ in range(2):
        reset_counts()
        t0 = time.perf_counter()
        tokens = server.generate(batch, LM_NEW)  # ends in a copy to the host
        runs.append((time.perf_counter() - t0, tokens))
        counts_are(f"{arch} Server.generate", want, totals)
    if not (runs[0][1] == runs[1][1]).all():
        fail(f"lm_serve_path: {arch} greedy tokens differ between two runs")
    if runs[0][1].shape != (LM_BATCH, LM_NEW) or not (
            (runs[0][1] >= 0) & (runs[0][1] < cfg.vocab)).all():
        fail(f"lm_serve_path: {arch} generated {runs[0][1].shape} out of range")
    gen_s = runs[1][0]
    decode_s = gen_s - prefill_s
    prompt_tokens = LM_BATCH * prompt_total
    info = {
        "layers": cfg.n_layers, "of_layers": full_layers,
        "dtype": "bfloat16", "batch": LM_BATCH, "prompt": LM_PROMPT,
        "new_tokens": LM_NEW, "param_bytes": param_bytes,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "init_peak_gb": init_peak_gb, "init_s": init_s, "prefill_s": prefill_s,
        "prefill_tokens_per_s": prompt_tokens / prefill_s,
        "generate_s": gen_s, "decode_s": decode_s,
        "decode_tokens_per_s": LM_BATCH * LM_NEW / decode_s,
        "prefill_launches": want, "server_stats": vars(server.stats),
        "prefill_profile": prefill_prof,
        f"decode_profile_{LM_CHECK_STEPS}_steps": decode_prof,
        "flash_staging_bytes": staging_bytes(cfg, LM_BATCH, prompt_total),
        "tokens_sha256": hashlib.sha256(runs[0][1].tobytes()).hexdigest(),
    }
    if arch in LM_KV_QUANT:
        qmodel = build_model(cfg.replace(kv_quant=True))
        reset_counts()
        t0 = time.perf_counter()
        qtokens = Server(qmodel, params, max_len=max_len, device="cuda").generate(
            batch, LM_NEW)
        info["kv_quant"] = {"generate_s": time.perf_counter() - t0,
                            "agree_with_dense": float((qtokens == runs[0][1]).mean())}
        counts_are(f"{arch} kv_quant Server.generate", want, totals)
        if not ((qtokens >= 0) & (qtokens < cfg.vocab)).all():
            fail(f"lm_serve_path: {arch} kv_quant tokens out of range")
    del params, server, batch
    torch.cuda.empty_cache()
    return info


def phase_lm_serve_path(torch) -> dict:
    """The language-model serving path (see the module docstring, step 12);
    returns the phase line, whose ``launches`` give each kernel's count over
    the routes' prefills and the Server runs."""
    from repro_torch.configs.base import list_configs

    t_start = time.perf_counter()
    totals = {k: 0 for k in all_counts()}
    routes = {arch: lm_route_check(torch, arch, totals) for arch in LM_CHECK_ARCHS}
    serve = {arch: lm_serve(torch, arch, totals) for arch in list_configs()}
    info = {"phase": "lm_serve_path", "gpu": gpu_line(),
            "route_check": {"dtype": "float32, then bfloat16 (bf16)",
                            "strict_fp32": True,
                            "batch": LM_CHECK_BATCH, "prompt": LM_CHECK_PROMPT,
                            "decode_steps": LM_CHECK_STEPS, "configs": routes},
            "serve": serve, "cut": {"layers": LM_SERVE_LAYERS,
                                    "batch": LM_BATCH, "prompt": LM_PROMPT},
            "launches": {"lm_serve": totals},
            "seconds": time.perf_counter() - t_start}
    emit(info)
    return info


# -- the language-model training path (lm_train_path) ------------------------
# step 1: one train step of every .smoke() config on the card and on the CPU
TRAIN_GRAD_REL = 1e-4  # max |cuda - cpu| over the leaf's largest |g| (and the loss)
# step 2: Llama-3.2-1B (configs/llama3_2_1b.py, hf:meta-llama/Llama-3.2-1B) at
# full width and depth in its bf16, remat "full", cut from the reference's
# train_4k cell (seq 4096, global batch 256) to what one card holds: batch 4,
# seq 2048 (the portable attention keeps O(T^2) fp32 scores and has no
# flash backward); AdamW lr 3e-4, warmup 4, grad clip 1.0; int8 gradient
# compression (CompressionConfig's defaults)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PROFILED = (
    "llama3_2_1b", 4, 2048, 30, 4)
# step 3: the same model cut to 2 of 16 layers (full width), seq 512, 10
# steps, a checkpoint every 4, one StepFailure at step 6
RECOVERY = {"layers": 2, "seq": 512, "steps": 10, "save_every": 4, "fail_at": 6,
            "keep": 2}
# step 4: GBATC-compressed checkpoint of the layer-0 slice of every stacked
# leaf of step 2's trained model (60.8 M values), at tau_rel 1e-3
CKPT_TAU = 1e-3
CKPT_LEAVES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.wg", "ffn.wu",
               "ffn.wd", "ln1.scale", "ln2.scale")
# make_train_step's profiler ranges; the rest of a step's device time is
# the forward and backward (the backward runs on autograd's own thread)
TRAIN_RANGES = ("train_step/compress_tree", "train_step/adamw")
H100_BF16_FLOPS = PEAK_FLOPS["bfloat16"]


class NoCheckpoints:
    """A checkpoint manager that keeps nothing: step 2 times train steps;
    saving a state that size is step 3's subject."""

    def latest_step(self):
        return None

    def save(self, step, tree, wait=False):
        return ""

    def wait(self):
        pass


def train_profile(torch, fn) -> dict:
    """``fn()`` under ``torch.profiler``: wall seconds, device seconds, the
    device's idle share, and the device time of each TRAIN_RANGES part
    (the kernels inside that range's device-side span) and of the forward
    and backward (the rest). Fails where the profiler gives no device
    time or no span of a range."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.device_type == cuda and e.name in TRAIN_RANGES]
    kernels = [(e.time_range.start, e.time_range.elapsed_us()) for e in events
               if e.device_type == cuda and e.name not in TRAIN_RANGES]
    missing = [name for name in TRAIN_RANGES if name not in {n for n, _, _ in spans}]
    if not kernels or missing:
        fail(f"lm_train_path: the profiler gave {len(kernels)} device kernels and "
             f"no device-side span of {missing}")
    busy = sum(us for _, us in kernels) / 1e6
    split = {}
    for name in TRAIN_RANGES:
        mine = [(a, b) for n, a, b in spans if n == name]
        split[name] = sum(us for t, us in kernels
                          if any(a <= t < b for a, b in mine)) / 1e6
    split["forward_backward"] = busy - sum(split.values())
    return {"wall_s": wall, "device_s": busy,
            "device_idle_share": max(0.0, 1 - busy / wall),
            "by_part_s": split, "kernels": len(kernels)}


def lm_train_backward_check(torch) -> dict:
    """Step 1: every .smoke() config in fp32 under strict_fp32, one
    make_train_step step on the card and on the CPU from the same
    parameters and batch: loss and every gradient leaf within
    TRAIN_GRAD_REL; no kernel launched (the portable route)."""
    from repro_torch.configs.base import get_config, list_configs
    from repro_torch.device import strict_fp32
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import (TrainConfig, init_train_state,
                                              loss_and_grads, make_train_step)

    out = {}
    tcfg = TrainConfig(optimizer=opt.AdamWConfig(lr=1e-3))
    for arch in list_configs():
        cfg = get_config(arch).smoke().replace(use_kernels=False)
        model = build_model(cfg)
        params_cpu = model.init(0, "cpu")
        res = {}
        for dev in ("cpu", "cuda"):
            params = {k: v.to(dev) for k, v in params_cpu.items()}
            batch = make_batch(cfg, batch=2, seq=16, kind="train", seed=1, device=dev)
            with strict_fp32():
                loss, grads = loss_and_grads(model.loss, params, batch)
                new_p, _, metrics = make_train_step(model, tcfg)(
                    params, init_train_state(model, params, tcfg), batch)
            res[dev] = (loss.cpu(), {k: g.cpu() for k, g in grads.items()},
                        {k: p.cpu() for k, p in new_p.items()}, float(metrics["loss"]))
        (l_c, g_c, p_c, m_c), (l_g, g_g, p_g, m_g) = res["cpu"], res["cuda"]
        loss_err = abs(float(l_g) - float(l_c)) / max(abs(float(l_c)), 1e-30)
        worst, worst_leaf = 0.0, None
        for k, g in g_c.items():
            top = float(g.abs().max())
            diff = float((g_g[k] - g).abs().max())
            rel = diff / top if top > 0 else (0.0 if diff == 0 else float("inf"))
            if rel > worst:
                worst, worst_leaf = rel, k
        if not (loss_err <= TRAIN_GRAD_REL and worst <= TRAIN_GRAD_REL
                and m_g == float(l_g) and m_c == float(l_c)):
            fail(f"lm_train_path: {arch} CUDA against CPU: loss {loss_err:.3e}, "
                 f"gradient {worst_leaf} {worst:.3e} of its largest |g| (limit "
                 f"{TRAIN_GRAD_REL})")
        out[arch] = {"loss_cpu": float(l_c), "loss_rel_err": loss_err,
                     "grad_worst_rel_err": worst, "grad_worst_leaf": worst_leaf,
                     "leaves": len(g_c), "params_after_step_max_abs_diff": max(
                         float((p_g[k] - p).abs().max()) for k, p in p_c.items())}
    return out


def lm_train_full_width(torch, totals: dict) -> tuple:
    """Step 2; returns (info, the trained parameters). One block_quant
    launch a step is held bitwise against its plain version on the same
    gradient: in step s, leaf (s mod leaves) of compress_tree, so that
    every leaf, embed and lm_head at (4.1 M, 64) among them, is held at the
    shape training gives it. The comparison runs inside the step, on the
    device (its flags are read when the run has ended)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.train import train
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import gradient_compression as gc
    from repro_torch.parallel.gradient_compression import CompressionConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    cfg = get_config(TRAIN_ARCH).replace(use_kernels=False, remat="full")
    tcfg = TrainConfig(optimizer=opt.AdamWConfig(lr=3e-4, warmup_steps=4,
                                                 total_steps=TRAIN_STEPS,
                                                 grad_clip=1.0),
                       compression=CompressionConfig())
    model = build_model(cfg)
    specs = model.specs()
    names = list(specs)
    n_params = sum(p.numel() for p in specs.values())
    n_leaves = len(specs)
    samples, calls = [], [0]
    real_bq = gc._block_quant

    def sampling(xb, n_bits, block):
        out = real_bq(xb, n_bits, block)
        step, leaf = divmod(calls[0], n_leaves)
        if leaf == step % n_leaves:
            want, want_sc = kref.block_quant_ref(xb, n_bits=n_bits, block=block)
            samples.append((step, names[leaf], tuple(xb.shape), torch.stack([
                (out[0] != want).any(), (out[1] != want_sc.reshape(-1)).any()])))
            del want, want_sc
        calls[0] += 1
        return out

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    gc._block_quant = sampling
    try:
        out = train(cfg, tcfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    ckpt=NoCheckpoints(), save_every=TRAIN_STEPS, log_every=0,
                    device="cuda")
        torch.cuda.synchronize()
    finally:
        gc._block_quant = real_bq
    counts_are("full-width training", {"block_quant": n_leaves * TRAIN_STEPS}, totals,
               "lm_train_path")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if list(out["params"]) != names:
        fail("lm_train_path: the trained parameters are not in the model's order")
    sampled = [{"step": st, "leaf": name, "blocks": list(shape),
                "bitwise_plain": not bool(bad.any())}
               for st, name, shape, bad in samples]
    blocks_of = {k: -(-p.numel() // tcfg.compression.block) for k, p in specs.items()}
    if (len(sampled) != TRAIN_STEPS or set(names) - {x["leaf"] for x in sampled}
            or any(x["blocks"][0] != blocks_of[x["leaf"]] for x in sampled)):
        fail(f"lm_train_path: the sampled block_quant launches do not cover every "
             f"leaf once a step: {[(x['step'], x['leaf']) for x in sampled]}")
    wrong = [x for x in sampled if not x["bitwise_plain"]]
    if wrong:
        fail(f"lm_train_path: block_quant launches differ from their plain version "
             f"on the training gradients: {wrong}")
    del samples
    losses = out["losses"]
    loss = falling(losses, f"{TRAIN_ARCH} full-width training", "lm_train_path")
    # where the time goes: TRAIN_PROFILED more steps under the profiler
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, batch=TRAIN_BATCH,
                                             seq_len=TRAIN_SEQ, seed=0))
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                pipe.batch_at(TRAIN_STEPS + i).items()} for i in range(TRAIN_PROFILED)]
    step_fn = make_train_step(model, tcfg)
    carry = {"params": out["params"], "state": out["state"]}
    step_s, train_s, step_list = out["median_step_s"], out["seconds"], out["step_seconds"]
    del out

    def steps():
        for b in batches:
            carry["params"], carry["state"], m = step_fn(carry["params"],
                                                         carry["state"], b)
            float(m["loss"])  # the loop's own synchronisation

    reset_counts()
    prof = train_profile(torch, steps)
    counts_are("profiled steps", {"block_quant": n_leaves * TRAIN_PROFILED}, totals,
               "lm_train_path")
    params = carry.pop("params")
    carry.clear()
    torch.cuda.empty_cache()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_embed = cfg.vocab * cfg.d_model  # the embedding lookup is no matmul
    flops_per_token = (6 * (n_params - n_embed)
                       + 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * TRAIN_SEQ)
    profiled_s = prof["wall_s"] / TRAIN_PROFILED
    info = {"arch": TRAIN_ARCH, "dtype": "bfloat16", "remat": cfg.remat,
            "layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TRAIN_STEPS, "params": n_params, "gradient_leaves": n_leaves,
            "compression": "int8, block 64, error feedback", "losses": losses,
            "loss": loss, "step_s": profiled_s, "tokens_per_s": tokens / profiled_s,
            "mfu": flops_per_token * tokens / profiled_s / H100_BF16_FLOPS,
            "train_s": train_s, "train_step_s_median": step_s,
            "train_step_seconds": step_list,
            "train_tokens_per_s": tokens / step_s,
            "train_mfu": flops_per_token * tokens / step_s / H100_BF16_FLOPS,
            "flops_per_token": flops_per_token,
            "flops_rule": "6 N (N without the embedding table) + 12 L H D T; "
                          "over the step's seconds and 989 TFLOP/s",
            "timing_note": "the profiled steps run after train() returned, "
                           "without the initial state run_with_recovery keeps "
                           "for a restart (ROADMAP C-ref-14); train()'s 30 "
                           "steps run with it, within a few GB of the card's "
                           "memory, and carry the sampled block_quant checks",
            "block_quant_sampled": sampled,
            "peak_device_gb": peak_gb, "reduced": {
                "from": "train_4k (seq 4096, global batch 256)",
                "seq": TRAIN_SEQ, "batch": TRAIN_BATCH},
            "profile_steps": TRAIN_PROFILED, "profile": prof}
    return info, params


class RecordingCheckpoints:
    """Step 3's checkpoint manager: a CheckpointManager writing
    synchronously (each save timed whole) that keeps a host copy of the
    tree it saved at ``hold`` and holds the tree a restore of that step
    gives back to it, byte for byte (the CRCs are checked by restore)."""

    def __init__(self, root: str, hold: int):
        from repro_torch.train import checkpoint as ck

        self.ck, self.hold = ck, hold
        self.mgr = ck.CheckpointManager(root, keep=RECOVERY["keep"], async_write=False)
        self.saves, self.restores, self.held, self.restored_bitwise = [], [], None, None

    def latest_step(self):
        return self.mgr.latest_step()

    def wait(self):
        self.mgr.wait()

    def save(self, step, tree, wait=False):
        t0 = time.perf_counter()
        path = self.mgr.save(step, tree, wait=True)
        self.saves.append({"step": step, "seconds": time.perf_counter() - t0})
        if step == self.hold:
            self.held = self.ck.flatten_tree(tree)
        return path

    def restore(self, tree_like, step=None):
        t0 = time.perf_counter()
        tree, got = self.mgr.restore(tree_like, step)
        self.restores.append({"step": got, "seconds": time.perf_counter() - t0})
        if got == self.hold:
            back = self.ck.flatten_tree(tree)
            self.restored_bitwise = (sorted(back) == sorted(self.held) and all(
                back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()
                for k, v in self.held.items()))
            if not self.restored_bitwise:
                fail(f"lm_train_path: the restore of step {got} is not what was saved")
        return tree, got


def lm_train_recovery(torch, totals: dict) -> dict:
    """Step 3: run_with_recovery twice from the same initialisation (seed
    0), with one StepFailure and without; final parameters and optimizer
    state bitwise equal; the restore bitwise what was saved."""
    from repro_torch.configs.base import get_config
    from repro_torch.device import deterministic
    from repro_torch.launch.train import train
    from repro_torch.train import optimizer as opt
    from repro_torch.train.fault_tolerance import StepFailure
    from repro_torch.train.train_loop import TrainConfig

    cfg = get_config(TRAIN_ARCH).replace(use_kernels=False, remat="full",
                                         n_layers=RECOVERY["layers"])
    # no gradient compression: the reference's checkpoint tree ({params,
    # opt}) holds no error-feedback residuals
    tcfg = TrainConfig(optimizer=opt.AdamWConfig(lr=3e-4, warmup_steps=4,
                                                 total_steps=RECOVERY["steps"],
                                                 grad_clip=1.0))
    fail_at, every = RECOVERY["fail_at"], RECOVERY["save_every"]
    restored = (fail_at - 1) // every * every  # the latest save before the failure
    fired = []

    def fail_once(step):
        if step == fail_at and not fired:
            fired.append(step)
            raise StepFailure("injected")

    runs, info = {}, {}
    base = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        for name, hook in (("failure", fail_once), ("clean", None)):
            mgr = RecordingCheckpoints(os.path.join(base, name), hold=restored)
            reset_counts()
            with deterministic():
                out = train(cfg, tcfg, steps=RECOVERY["steps"], batch=TRAIN_BATCH,
                            seq=RECOVERY["seq"], ckpt=mgr, save_every=every,
                            log_every=0, device="cuda", before_step=hook)
            torch.cuda.synchronize()
            counts_are(f"recovery run ({name})", {}, totals, "lm_train_path")
            runs[name] = out
            info[name] = {"report": out["report"], "losses": out["losses"],
                          "seconds": out["seconds"], "median_step_s": out["median_step_s"],
                          "saves": mgr.saves, "restores": mgr.restores}
            if name == "failure":
                if out["report"]["restarts"] != 1 or mgr.restored_bitwise is not True:
                    fail(f"lm_train_path: recovery run: {out['report']}, restore "
                         f"bitwise {mgr.restored_bitwise}")
                info[name]["restored_step"] = restored
                info[name]["restore_bitwise"] = True
            shutil.rmtree(os.path.join(base, name), ignore_errors=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    a, b = runs["failure"], runs["clean"]
    equal = (all(torch.equal(a["params"][k], p) for k, p in b["params"].items())
             and all(torch.equal(a["state"]["opt"][part][k], t)
                     for part in ("m", "v") for k, t in b["state"]["opt"][part].items())
             and a["state"]["opt"]["step"] == b["state"]["opt"]["step"])
    if not equal:
        fail("lm_train_path: the recovered run's parameters or optimizer state "
             "differ from the uninterrupted run's")
    info.update({"final_bitwise_equal": True, "layers": cfg.n_layers,
                 "seq": RECOVERY["seq"], "batch": TRAIN_BATCH, **RECOVERY,
                 "deterministic_algorithms": "warn_only, scoped (device.deterministic)",
                 "checkpoint_bytes": sum(t.numel() * (t.element_size() + 8)
                                         for t in b["params"].values())})
    del runs, a, b
    torch.cuda.empty_cache()
    return info


def lm_train_compressed_checkpoint(torch, params: dict, totals: dict) -> dict:
    """Step 4: compress_state_bytes (device "cuda") of the layer-0 slices
    of the trained model's stacked leaves, one leaf a call: one projection
    and one select launch each (D = 256), each held against its plain
    version on the operands the engine gave it (FP64_REL_LIMIT,
    FP32_LIMIT); every 256-block within the bound (the reference test's
    tau (1 + 1e-6), plus the fp32 rounding of the stored block, which the
    reference's own result needs too at tau_rel 1e-3); seconds of the
    engine's prepare and select and of the entropy coder (wrapped here
    while the step runs; the operands are copied there and compared after
    the call)."""
    import numpy as np

    from repro_torch.core import entropy, gae
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.train.checkpoint import compress_state_bytes

    flat = {f"layers/{name.replace('.', '/')}/0":
            params[f"layers.{name}"][0].float().cpu().numpy()  # bf16 -> fp32 exactly
            for name in CKPT_LEAVES}
    stages = {"prepare": 0.0, "select": 0.0, "entropy": 0.0}
    real = {}

    def timed(owner, attr, stage):
        fn = getattr(owner, attr)
        real[owner, attr] = fn

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                stages[stage] += time.perf_counter() - t0

        setattr(owner, attr, wrapped)

    launched = []

    def kept(name):
        fn = getattr(ops, name)
        real[ops, name] = fn

        def wrapped(*a, **kw):
            got = fn(*a, **kw)
            launched.append((name, [t.clone() for t in a], got.clone()))
            return got

        setattr(ops, name, wrapped)

    timed(gae.GuaranteeEngine, "prepare", "prepare")
    timed(gae.GuaranteeEngine, "select", "select")
    timed(entropy, "huffman_encode", "entropy")
    timed(entropy, "zstd_bytes", "entropy")
    kept("gbatc_project_batched")
    kept("gbatc_select_accumulate")
    leaves, raw, packed = {}, 0, 0
    t_start = time.perf_counter()
    try:
        for k, v in flat.items():
            reset_counts()
            t0 = time.perf_counter()
            rec, nbytes, rep = compress_state_bytes({k: v}, tau_rel=CKPT_TAU,
                                                    device="cuda")
            seconds = time.perf_counter() - t0
            counts_are(f"compressed checkpoint {k}", {"gbatc_project_batched": 1,
                                                      "gbatc_select_accumulate": 1},
                       totals, "lm_train_path")
            plain_err = {}
            for name, args, got in launched:
                dtype = torch.float64 if name == "gbatc_project_batched" else torch.float32
                plain = getattr(kref, name + "_ref")(*args)
                plain_err[name] = {"shape": list(got.shape), "max_abs_err": compare(
                    torch, got, plain, args[0], dtype)}
            if sorted(plain_err) != sorted(GBATC_KERNELS[:2]) or any(
                    e["shape"][-1] != 256 for e in plain_err.values()):
                fail(f"lm_train_path: compressed {k}: launches {plain_err}")
            launched.clear()
            # the reference test's check, in its fp32 arithmetic, plus the
            # fp32 rounding of the stored block (half an ulp an element,
            # at most 2^-24 |rec block|): the engine meets tau in fp64
            blocks, rblocks = v.reshape(-1, 256), rec[k].reshape(-1, 256)
            norms = np.linalg.norm(blocks - rblocks, axis=1)
            bound = CKPT_TAU * np.sqrt(np.mean(blocks ** 2)) * np.sqrt(256)
            storage = 2.0 ** -24 * np.linalg.norm(rblocks, axis=1)
            if not (norms <= bound * (1 + 1e-6) + storage).all():
                fail(f"lm_train_path: compressed {k}: a block misses its bound "
                     f"({float(norms.max()):.6e} > {float(bound):.6e})")
            raw += rep["raw_bytes"]
            packed += nbytes
            leaves[k] = {"shape": list(v.shape), "blocks": blocks.shape[0],
                         "ratio": rep["ratio"], "seconds": seconds,
                         "worst_block_over_bound": float(norms.max() / bound),
                         "blocks_over_bound_1e-6": int((norms > bound * (1 + 1e-6)).sum()),
                         "worst_excess_in_storage_rounding": float(
                             ((norms - bound) / storage).max()),
                         "kernels_against_plain": plain_err}
    finally:
        for (owner, attr), fn in real.items():
            setattr(owner, attr, fn)
    return {"tau_rel": CKPT_TAU, "values": int(sum(v.size for v in flat.values())),
            "leaves": leaves, "raw_bytes": raw, "compressed_bytes": packed,
            "ratio": raw / packed, "seconds": time.perf_counter() - t_start,
            "stage_seconds": stages, "input": "fp32 copies of the bf16 weights "
            "(exact); embed and lm_head (262.7 M values each) left out: the host "
            "Huffman coder would take about 90 s each"}


def lm_train_entry_point(torch) -> dict:
    """Step 5: python -m repro_torch.launch.train --steps 20 at its smoke
    defaults on the card, in a subprocess: exit 0, a falling loss."""
    ck = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=os.path.join(ROOT, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    try:
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                            "--steps", "20", "--ckpt-dir", ck],
                           capture_output=True, text=True, timeout=600, env=env,
                           cwd=ROOT)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    seconds = time.perf_counter() - t0
    line = next((ln for ln in p.stdout.splitlines() if ln.startswith("loss ")), "")
    try:
        first, last = (float(x) for x in line.split(";")[0][5:].split(" -> "))
    except ValueError:
        first = last = float("nan")
    if p.returncode != 0 or not last < first:
        fail(f"lm_train_path: launch.train exited {p.returncode} ({line!r}):\n"
             f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
    return {"command": "python -m repro_torch.launch.train --steps 20",
            "returncode": p.returncode, "loss_first": first, "loss_last": last,
            "seconds": seconds, "stdout_head": p.stdout.splitlines()[:2]}


def phase_lm_train_path(torch) -> dict:
    """The language-model training path (see the module docstring, step
    12); returns the phase line, whose ``launches`` give each kernel's
    count per step (the profiled steps included in ``full_width``)."""
    t_start = time.perf_counter()
    info = {"phase": "lm_train_path", "gpu": gpu_line()}
    seconds = {}
    totals = {part: {k: 0 for k in all_counts()} for part in
              ("backward_check", "full_width", "recovery", "compressed_checkpoint")}
    t0 = time.perf_counter()
    reset_counts()
    info["backward_check"] = lm_train_backward_check(torch)
    counts_are("backward check", {}, totals["backward_check"], "lm_train_path")
    seconds["backward_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the full-width step holds the initial state run_with_recovery keeps
    # for a restart beside the current one (ROADMAP C-ref-14) and peaks near
    # 74 GB; in fixed segments the caching allocator fragments past the
    # card's 80 GB there. The segments it allocates in this step alone are
    # expandable: they change where memory comes from, not what a kernel
    # computes, and the earlier phases run in the allocator's defaults.
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        info["full_width"], params = lm_train_full_width(torch, totals["full_width"])
        info["full_width"]["expandable_segments"] = sum(
            bool(seg.get("is_expandable")) for seg in torch.cuda.memory_snapshot())
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    seconds["full_width"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info["recovery"] = lm_train_recovery(torch, totals["recovery"])
    seconds["recovery"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info["compressed_checkpoint"] = lm_train_compressed_checkpoint(
        torch, params, totals["compressed_checkpoint"])
    seconds["compressed_checkpoint"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    info["entry_point"] = lm_train_entry_point(torch)
    seconds["entry_point"] = time.perf_counter() - t0
    info["launches"] = totals
    info["seconds_by_step"] = seconds
    info["seconds"] = time.perf_counter() - t_start
    emit(info)
    return info


# -- the dry run (dryrun_path) --------------------------------------------------
# gate 2's decode step: lm_train_path's batch on a cache of this length
DRYRUN_DECODE_LEN = 4096
DRYRUN_TIMED_STEPS = 3  # timed train steps after one warm-up, for the HFU
DRYRUN_TIMEOUT_S = 600  # each dry-run child's limit


def dryrun_children(out_dir: str) -> dict:
    """Gate 1's children: ``python -m repro_torch.launch.dryrun --arch <a>
    --mesh both --out <out_dir>``, one per config, all started together."""
    from repro_torch.configs.base import list_configs

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--mesh", "both", "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for arch in list_configs()}


def dryrun_cells(torch, procs: dict, out_dir: str) -> dict:
    """Gate 1: every child exits 0 with CUDA never initialised and writes
    exactly its config's cells (cfg.shapes x 2 meshes); one line a cell."""
    from repro_torch.configs.base import get_config

    total = torch.cuda.get_device_properties(0).total_memory
    cells, children = [], {}
    for arch, p in procs.items():
        out, err = p.communicate(timeout=DRYRUN_TIMEOUT_S)
        lines = out.splitlines()
        children[arch] = {"returncode": p.returncode,
                          "cuda_line": next((ln for ln in lines
                                             if ln.startswith("[dryrun] cuda_")), None)}
        if p.returncode != 0 or "[dryrun] cuda_initialized=False" not in lines:
            fail(f"dryrun_path: the dry run of {arch} exited {p.returncode} "
                 f"({children[arch]['cuda_line']}):\n{out[-2000:]}\n{err[-3000:]}")
        want = {f"{arch}__{shape}__{mesh}.json" for shape in get_config(arch).shapes
                for mesh in ("pod16x16", "pod2x16x16")}
        got = {f for f in os.listdir(out_dir) if f.startswith(arch + "__")}
        if got != want:
            fail(f"dryrun_path: {arch} wrote {sorted(got)}, expected {sorted(want)}")
        for name in sorted(want):
            with open(os.path.join(out_dir, name)) as f:
                cell = json.load(f)
            arg = cell["memory"]["argument_size_in_bytes"]
            out = cell["memory"]["output_size_in_bytes"]
            line = {"phase": "dryrun_path", "cell": name[:-5],
                    "argument_gb_per_device": arg / 1e9, "output_gb_per_device": out / 1e9,
                    "card_total_gb": total / 1e9,
                    # no argument is donated: both are held at the step's end
                    # (temp bytes have no counterpart on meta tensors)
                    "arguments_and_outputs_fit": arg + out <= total,
                    "unread_gb": cell["memory"]["unread_bytes"] / 1e9,
                    "flops_global": cell["flops"], "n_devices": cell["n_devices"],
                    "trace_s": cell["trace_s"]}
            emit(line)
            cells.append(line)
    if len(cells) != 64:
        fail(f"dryrun_path: {len(cells)} cells written, expected 64")
    return {"cells": len(cells),
            "arguments_and_outputs_fit": sum(c["arguments_and_outputs_fit"] for c in cells),
            "children": children}


def phase_dryrun_path(torch) -> dict:
    """The dry run and its two checks on the card (see the module
    docstring, step 13); returns the phase line, whose ``launches`` give
    each kernel's count over the real steps (none: the portable route)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig, init_train_state, make_train_step

    t_start = time.perf_counter()
    info = {"phase": "dryrun_path", "gpu": gpu_line()}
    totals = {"real_steps": {k: 0 for k in all_counts()}}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_", dir=os.path.join(ROOT, "build"))
    procs = dryrun_children(out_dir)
    try:
        # gates 2 and 3 while the children count on the host: lm_train_path's
        # full-width cell without the gradient compression
        cfg = get_config(TRAIN_ARCH).replace(use_kernels=False, remat="full")
        shape = ShapeSpec("lm_train_path", TRAIN_SEQ, TRAIN_BATCH, "train")
        dshape = ShapeSpec("lm_train_path_decode", DRYRUN_DECODE_LEN, TRAIN_BATCH, "decode")
        one = make_mesh((1, 1), ("data", "model"))
        t0 = time.perf_counter()
        meta, dmeta = dryrun.step_flops(cfg, shape), dryrun.step_flops(cfg, dshape)
        meta_s = time.perf_counter() - t0
        arg, parts = dryrun.argument_bytes(cfg, shape, one, meta["reads"])
        darg, dparts = dryrun.argument_bytes(cfg, dshape, one, dmeta["reads"])
        out_b, out_parts = dryrun.output_bytes(cfg, shape, one, meta["outputs"])
        dout_b, dout_parts = dryrun.output_bytes(cfg, dshape, one, dmeta["outputs"])
        torch.cuda.empty_cache()
        model = build_model(cfg)
        tcfg = TrainConfig(optimizer=opt.AdamWConfig(lr=1e-4))
        params = model.init(0, device="cuda")
        state = init_train_state(model, params, tcfg)
        batch = make_batch(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, kind="train",
                           device="cuda")
        storage = sum(t.untyped_storage().nbytes() for t in (
            *params.values(), *state["opt"]["m"].values(), *state["opt"]["v"].values(),
            *batch.values()))
        # the step count is the reference's int32 argument; the port's is a host int
        if storage != arg - parts["opt.step"] or parts["opt.step"] != 4:
            fail(f"dryrun_path: the training state holds {storage} bytes on the card, "
                 f"the dry run accounts {arg} ({parts}) with a 4-byte step count")
        step = make_train_step(model, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with FlopCounterMode(display=False) as counter:
            out = step(params, state, batch)
            loss = float(out[2]["loss"])
        # the outputs, less the step count and learning rate kept on the host
        out_storage = sum(t.untyped_storage().nbytes() for t in (
            *out[0].values(), *out[1]["opt"]["m"].values(), *out[1]["opt"]["v"].values(),
            *out[2].values()) if isinstance(t, torch.Tensor))
        out_want = out_b - out_parts["tuple_table"] - out_parts["opt.step"] - 4
        del out
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts_are("the counted train step", {}, totals["real_steps"], "dryrun_path")
        real = int(counter.get_total_flops())
        if real != meta["flops"]:
            fail(f"dryrun_path: the train step counts {real} FLOPs on the card, "
                 f"the dry run {meta['flops']}")
        if out_storage != out_want:
            fail(f"dryrun_path: the train step's outputs hold {out_storage} bytes on the "
                 f"card, the dry run accounts {out_want} ({out_parts})")
        cache = {k: torch.zeros(v.shape, dtype=v.dtype, device="cuda")
                 for k, v in model.cache_specs(TRAIN_BATCH, DRYRUN_DECODE_LEN).items()}
        cache["len"].fill_(TRAIN_SEQ)
        tokens = make_batch(cfg, batch=TRAIN_BATCH, seq=1, kind="decode",
                            device="cuda")["tokens"]
        dstorage = sum(t.untyped_storage().nbytes()
                       for t in (*params.values(), *cache.values(), tokens))
        if dstorage != darg:
            fail(f"dryrun_path: the decode arguments hold {dstorage} bytes on the card, "
                 f"the dry run accounts {darg} ({dparts})")
        reset_counts()
        with FlopCounterMode(display=False) as counter:
            logits, new_cache = model.decode_step(params, cache, tokens)
            torch.cuda.synchronize()
        dout_storage = logits.untyped_storage().nbytes() + sum(
            t.untyped_storage().nbytes() for t in new_cache.values())
        del new_cache
        if dout_storage != dout_b - dout_parts["tuple_table"]:
            fail(f"dryrun_path: the decode step's outputs hold {dout_storage} bytes on the "
                 f"card, the dry run accounts {dout_b} ({dout_parts})")
        counts_are("the counted decode step", {}, totals["real_steps"], "dryrun_path")
        dreal = int(counter.get_total_flops())
        if dreal != dmeta["flops"] or not bool(torch.isfinite(logits).all()):
            fail(f"dryrun_path: the decode step counts {dreal} FLOPs on the card, the "
                 f"dry run {dmeta['flops']} (finite logits: "
                 f"{bool(torch.isfinite(logits).all())})")
        del logits, cache
        gates_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["cells"] = dryrun_cells(torch, procs, out_dir)
        info["cells"]["seconds"] = time.perf_counter() - t0
        # the step's time, with the children done: a warm-up, then timed steps
        reset_counts()
        times = []
        for i in range(DRYRUN_TIMED_STEPS + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = step(params, state, batch)
            float(out[2]["loss"])
            del out
            times.append(time.perf_counter() - t1)
        counts_are("the timed train steps", {}, totals["real_steps"], "dryrun_path")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)
    del params, state, batch
    torch.cuda.empty_cache()
    step_s = statistics.median(times[1:])
    tokens_n = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for p in model.specs().values())
    rule = (6 * (n_params - cfg.vocab * cfg.d_model)
            + 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * TRAIN_SEQ)
    info["train_step"] = {
        "arch": TRAIN_ARCH, "dtype": "bfloat16", "remat": cfg.remat,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "compression": None,
        "flops_meta": meta["flops"], "flops_card": real, "equal": True,
        "depth_fit": meta["depth_fit"], "loss": loss,
        "flops_per_token_counted": real / tokens_n, "flops_per_token_rule": rule,
        "counted_over_rule": real / tokens_n / rule,
        "rule": "6 N (N without the embedding table) + 12 L H D T (lm_train_path)",
        "step_s_median": step_s, "step_seconds": times,
        "hfu": real / step_s / H100_BF16_FLOPS,
        "mfu": rule * tokens_n / step_s / H100_BF16_FLOPS,
        "argument_bytes": arg, "bytes_by_part": parts, "storage_bytes_on_card": storage,
        "output_bytes": out_b, "output_bytes_by_part": out_parts,
        "output_storage_bytes_on_card": out_storage,
        "peak_bytes": peak, "peak_minus_arguments_bytes": peak - storage}
    info["decode_step"] = {
        "batch": TRAIN_BATCH, "cache_len": DRYRUN_DECODE_LEN, "flops_meta": dmeta["flops"],
        "flops_card": dreal, "equal": True, "argument_bytes": darg,
        "bytes_by_part": dparts, "storage_bytes_on_card": dstorage,
        "output_bytes": dout_b, "output_bytes_by_part": dout_parts,
        "output_storage_bytes_on_card": dout_storage}
    info["seconds_by_step"] = {"meta_counts": meta_s, "gates_2_3": gates_s,
                               "cells_wait": info["cells"]["seconds"]}
    info["launches"] = totals
    info["seconds"] = time.perf_counter() - t_start
    emit(info)
    return info


# analysis_path: each program's own kernel, by launch counter
ANALYSIS_KERNELS = {
    "gbatc_project_batched": "gbatc_project_batched",
    "gbatc_project_shard": "gbatc_project_batched",
    "gbatc_select_accumulate": "gbatc_select_accumulate",
    "gbatc_select_accumulate_shard": "gbatc_select_accumulate",
    "gbatc_correct_batched": "gbatc_correct_batched",
    "fused_decode_attention": "flash_attention",
    "trainer_mesh_dp_quantized": "block_quant",
}
ANALYSIS_CLI_TIMEOUT_S = 300


def phase_analysis_path(torch, main_codec, attention_artifact) -> dict:
    """The invariant checker on the card (see the module docstring, step
    14); returns the phase line, whose ``launches`` are the registry's."""
    from repro_torch.analysis import trace_audit

    t_start = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cli = subprocess.Popen([sys.executable, "-m", "repro_torch.analysis"],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env, cwd=ROOT)
    try:
        t0 = time.perf_counter()
        w = trace_audit.workload_from(main_codec.pipeline, attention_artifact)
        workload_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        report = trace_audit.audit(workload=w)
        registry_s = time.perf_counter() - t0
        launches = all_counts()
        out, err = cli.communicate(timeout=ANALYSIS_CLI_TIMEOUT_S)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
    cli_s = time.perf_counter() - t_start
    summary = next((ln for ln in out.splitlines()
                    if ln.startswith("repro_torch.analysis:")), None)
    if cli.returncode != 0 or summary is None or "on cuda" not in summary:
        fail(f"analysis_path: python -m repro_torch.analysis exited "
             f"{cli.returncode}:\n{out[-3000:]}\n{err[-3000:]}")
    if report.findings:
        fail("analysis_path: the audit at the main path's width found: "
             + "; ".join(str(f) for f in report.findings))
    if list(report.programs) != [
            "trainer_stream_step", "trainer_scan_hot", "trainer_scan_log_every",
            "trainer_mesh_dp", "trainer_mesh_dp_quantized", "fused_decode",
            "fused_decode_corrected", "fused_decode_attention",
            "gbatc_project_batched", "gbatc_correct_batched",
            "gbatc_select_accumulate", "gbatc_project_shard",
            "gbatc_select_accumulate_shard"]:
        fail(f"analysis_path: the registry ran {list(report.programs)}")
    for name, st in report.programs.items():
        kernel = ANALYSIS_KERNELS.get(name)
        if kernel and not st.launches.get(kernel):
            fail(f"analysis_path: {name} launched no {kernel} kernel "
                 f"({st.launches})")
        if st.device_syncs is None:
            fail(f"analysis_path: {name} ran without the card's sync check")
        emit({"phase": "analysis_path", "program": name, "ops": st.n_ops,
              "syncs": st.syncs, "device_syncs": st.device_syncs,
              "fp64_ops": st.f64_ops, "transfers": st.transfers,
              "transfer_bytes": st.transfer_bytes, "captured_bytes": st.const_bytes,
              "collectives": st.collectives, "in_place": st.in_place,
              "launches": st.launches, "seconds": st.seconds})
    log = report.programs["trainer_scan_log_every"]
    if log.syncs != {"_local_scalar_dense": 2} or log.device_syncs != 3:
        fail(f"analysis_path: log_every synced {log.syncs} / {log.device_syncs}x "
             "on the card, expected 2 logged losses and one history fetch")
    shape = [int(n) for n in w.x.shape]
    del w, report
    torch.cuda.empty_cache()
    info = {"phase": "analysis_path", "gpu": gpu_line(), "cli_summary": summary,
            "cli_and_registry_s": cli_s, "workload_s": workload_s,
            "registry_s": registry_s, "guarantee_shape": shape,
            "findings": 0, "launches": {"registry": launches},
            "seconds": time.perf_counter() - t_start}
    emit(info)
    return info


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="env,build,kernels,main_path,attention_path,ops_path,"
                            "partial_path,serve_path,stream_path,mesh_path,lm_serve_path,"
                            "lm_train_path,dryrun_path,analysis_path")
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
        lm_shapes = phase_lm_kernels(torch, launches)
        for r in rows:  # lm_serve_path's shapes beside the codec's
            if r["name"] in lm_shapes:
                r["lm_serve_shapes"] = lm_shapes[r["name"]]
    paths, outputs = {}, {}
    for phase in ("partial_path", "serve_path"):
        if phase in phases and not {"main_path", "attention_path"} <= set(phases):
            fail(f"{phase} needs the main_path and attention_path phases")
    for phase in ("stream_path", "mesh_path"):
        if phase in phases and "main_path" not in phases:
            fail(f"{phase} needs the main_path phase")
    if "analysis_path" in phases and not {"main_path", "attention_path"} <= set(phases):
        fail("analysis_path needs the main_path and attention_path phases")
    data = temperature = main_codec = attention_artifact = None
    if "main_path" in phases or "attention_path" in phases:
        data, temperature, gen_s = generate(args)
        emit({"phase": "generate", "shape": list(data.shape), "seconds": gen_s})
        if "main_path" in phases:
            paths["main_path"], *outputs["main_path"], main_codec = \
                phase_main_path(torch, args, data)
        if "attention_path" in phases:
            paths["attention_path"], *outputs["attention_path"], attention_artifact = \
                phase_attention_path(torch, args, data)
    ops_calls = phase_ops_path(torch) if "ops_path" in phases else {}
    partial = (phase_partial_path(torch, outputs["main_path"],
                                  outputs["attention_path"])
               if "partial_path" in phases else None)
    serve = (phase_serve_path(torch, args, outputs["main_path"],
                              outputs["attention_path"])
             if "serve_path" in phases else None)
    stream = (phase_stream_path(torch, args, paths["main_path"], data, temperature,
                                outputs["main_path"][2])
              if "stream_path" in phases else None)
    # analysis_path runs last, on main_path's fit and attention_path's blob
    analysis_inputs = ((main_codec, attention_artifact)
                       if "analysis_path" in phases else None)
    attention_artifact = None
    outputs.clear()
    mesh = (phase_mesh_path(torch, args, paths["main_path"], data, main_codec)
            if "mesh_path" in phases else None)
    main_codec = None
    del data, temperature
    lm = phase_lm_serve_path(torch) if "lm_serve_path" in phases else None
    lm_train = phase_lm_train_path(torch) if "lm_train_path" in phases else None
    dry = phase_dryrun_path(torch) if "dryrun_path" in phases else None
    analysis = (phase_analysis_path(torch, *analysis_inputs)
                if "analysis_path" in phases else None)
    analysis_inputs = None
    for r in rows:
        by_path = {p: {"compress": info["launches_compress"][r["name"]],
                       "decompress": info["launches_decompress"][r["name"]],
                       "second_compress": info["launches_second_compress"][r["name"]]}
                   for p, info in paths.items()}
        if ops_calls:
            by_path["ops_path"] = {op: c["launches"][r["name"]]
                                   for op, c in ops_calls.items()}
        for name, line in (("partial_path", partial), ("serve_path", serve)):
            if line:
                by_path[name] = {part: c[r["name"]]
                                 for part, c in line["launches"].items()}
        if stream:
            by_path["stream_path"] = {"fit_stream_and_compress":
                                      stream["launches"][r["name"]]}
        if mesh:
            by_path["mesh_path"] = {part: c[r["name"]]
                                    for part, c in mesh["launches"].items()}
        for name, line in (("lm_serve_path", lm), ("lm_train_path", lm_train),
                           ("dryrun_path", dry), ("analysis_path", analysis)):
            if line:
                by_path[name] = {part: c[r["name"]]
                                 for part, c in line["launches"].items()}
        r["launches_by_path"] = by_path
        r["launches"] = sum(sum(c.values()) for c in by_path.values())
    complete = all(p in phases for p in ("build", "kernels", "main_path",
                                         "attention_path", "ops_path",
                                         "partial_path", "serve_path",
                                         "stream_path", "mesh_path",
                                         "lm_serve_path", "lm_train_path",
                                         "dryrun_path", "analysis_path"))
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
