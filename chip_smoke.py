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
   each element's value plus 4e-5 (``bf16_ulp_ratio`` <= 1), every fp32
   one (the CUDA-core kernel to D = 32, 3xTF32 tensor cores above, a
   ragged D among them) within 2e-5;
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
6. ``wide_block_path``  the conv family at an 8 x 8 x 8 block (D = 512,
   every GBATC kernel past its panels) on main_path's field cut to its
   first 8 frames (NB = 1600 a species), with main_path's gates through
   ``drive()`` (bound after decompress(bytes), decode bitwise the
   encoder's reconstruction, second bound with no projection launch,
   select backends byte for byte), then one selective decode of species
   0, 17 and 57, bitwise the full decode's slice with one replay launch;
   the ``kernels`` phase holds all six (kernel, dtype) routes of the three
   batched kernels at every ``ANY_D`` shape (D = 130 to 1000) against their
   plain versions, for the same bits twice and by row and species
   sub-range, pins their outputs' sha256 in ``ANY_D_SHA256``, and times
   them at (58, 1600, 512); the 2D pair at D = 130 and 512 in both dtypes;
   then ``wide_head_path``: the attention family with one 512-wide head
   (arch (512, 1, 1, 1024), head dim 512: flash past D = 256, launched in
   compress and in decompress) on the same 8 frames
   through ``drive()`` with the same gates, compress and decompress under
   a CUDA-only profiler for flash's device share of each, and one
   selective decode of species 2, 31 and 57, bitwise, with one replay
   launch and flash. The
   ``kernels`` phase holds every widened domain: flash past D = 256 and
   past 65,535 query tiles, ``rwkv6_scan`` past N = 64, ``rglru_scan``
   past 65,535 batch rows and every GBATC route past 65,535 species (fp32
   project and correct at a basis past 2^31 elements), each against its
   plain version, the same bits twice and for a sub-range, the rows or
   species the CTAs take on a second pass bitwise their own call; and it
   holds every kernel inside its old domain to the sha256s of the build
   before that widening (``OLD_DOMAIN_SHA256``), flash past D = 256
   to those of its tensor-core kernel's first build (``FLASH_WIDE_SHA256``)
   and ``rwkv6_scan`` past N = 64 to those of ``rwkv6_chunked``'s first
   build (``RWKV_WIDE_SHA256``, both timed paths included);
7. ``ops_path``  each of the six ``repro_torch.kernels.ops.*_op`` functions
   (the JAX package's ``kernels/ops.py``, name for name) once at its
   full-width shape, from numpy inputs on the default device, against its
   plain version, with the launch counts reset just before each call and
   read just after (each call launches its own kernel once and nothing
   else); the ``kernels`` phase also holds the five kernels behind them
   that no other path runs (2D GBATC pair, block_quant, rglru_scan,
   rwkv6_scan) against their plain versions at those shapes, at the
   reference's sweeps and in bf16, and each for the same bits twice; the
   fp32 2D projection also for rows 100-5003 and the field's last rows,
   and rwkv6_scan for batch 0-1, as in the full call; rglru_scan bitwise
   its plain version (h and h_T, both dtypes, with and without h0, at the
   ring's ragged and unaligned edges), and for batch 0-1 and channels
   33-96 as in the full call;
8. ``partial_path``  on the blobs, artifact and decoded fields of the two
   codec paths (no new fit): selective decodes of the conv blob
   (``decompress(blob, species=..., time_range=...)``) bitwise against the
   slice of its full decode, cold and warm, with their bytes parsed and
   exactly one replay launch each; the conv artifact written at container
   v1-v4 and read back bitwise, v1 in full, the staged
   ``decompress_reference`` bitwise the fused decode; ``verify_blob`` over
   one seeded bit flip a region of the blob (all must be detected), one corrupt
   species and one corrupt latent shard raised in raise mode and
   quarantined by salvage (bitwise elsewhere); one selective decode of the
   attention blob through flash attention;
9. ``serve_path``  the decode service (``repro_torch.serve.DecodeService``)
   on the two codec paths' blobs (no new fit): a seeded mix of 16
   selective requests (4 duplicates, one unknown blob, one malformed)
   from 8 client threads, every answer bitwise the slice of its blob's
   full decode, exactly the planted requests failing, fewer fused
   dispatches than requests, and no kernel but the replay (and flash for
   the attention blob); the same mix served serially through
   ``PartialDecoder`` for comparison, both cold and both warm; one tick
   holding a corrupt species, its batch-mates and a salvage request; and
   the gap a fused decode shows when cuDNN's TF32 is on (what
   ``strict_fp32`` prevents);
10. ``stream_path``  ``GBATCCodec.fit_stream`` over the main field in
   chunks of 4 frames, one injected I/O fault in each ingest pass, then
   the 1e-3 compress: the blob must be main_path's byte for byte, with
   one projection and one select launch; then the QoI (net production
   rates, ``repro_torch.core.qoi``) of the field and of its decode on the
   card against the same map on the host;
11. ``mesh_path``  the mesh-sharded fit and compress (``repro_torch.parallel``)
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
12. ``lm_serve_path``  the language-model serving path
   (``repro_torch.models``, ``repro_torch.serve.Server``) on the card: (a)
   Llama-3.2-1B, StableLM-3B, Yi-9B, RWKV-6 7B, RecurrentGemma-2B and
   Whisper-base in fp32 (and two ``.smoke()`` configs widened past the
   kernels' old domains: Llama with 320-wide heads, RWKV-6 with 128-wide)
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
   plain versions, bf16 within one bf16 ulp of each element's value, flash
   in both dtypes faster than its plain version and giving the same bits
   twice and for a batch sub-range, timed beside SDPA and their bounds
   (fp32's is 3xTF32's, with the CUDA cores' beside it). This phase runs
   in a process of its own (this script with ``--child lm_serve_path``),
   started after ``wide_head_path`` and waited for after ``mesh_path``, so
   its times are taken beside those phases'; its lines print where it
   would have run;
13. ``lm_train_path``  the language-model training path
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
   tokens/s and MFU; (3) the same model cut to 2 layers, seq 512, 6 steps under
   ``run_with_recovery`` with a checkpoint every 3 steps, once with a
   ``StepFailure`` at step 5 and once without (keeping no checkpoint):
   final parameters and optimizer state bitwise equal, the restore bitwise
   what was saved, each save timed; (4) ``compress_state_bytes`` at tau_rel 1e-3 of the layer-0
   slice of every stacked leaf of (2)'s trained model: one fp64 projection
   and one fp32 select launch a leaf at D = 256, each held against its
   plain version on the engine's operands, every 256-block within its
   bound, the ratio and the seconds of prepare, select and entropy coding;
   (5) ``python -m repro_torch.launch.train --steps 20`` in a subprocess:
   exit 0 and a falling loss. The ``kernels`` phase holds the wide
   routes (past D = 128) of the fp64 projection and the fp32 select and
   correct at every ``WIDE`` shape (``batched_checks``, as at D = 80),
   holds the sha256 of their outputs at every ``WIDE`` shape to
   ``WIDE_SHA256`` (see there), prints them on a line of their own, and
   times the kernels at (1, 65536, 256);
14. ``dryrun_path``  the dry run (``repro_torch.launch.dryrun``, meta tensors
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
   reported. The children of (1) start after the ``kernels`` phase, at
   a lower priority, and count beside the codec paths;
15. ``analysis_path``  the invariant checker (``repro_torch.analysis``) on
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
16. the ``{"kernels": [...]}`` line, the card line, the ``total`` line
   (with each phase's seconds in this process), and the final ``ok`` line.

Without CUDA the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import atexit
import bisect
import hashlib
import json
import math
import os
import re
import shutil
import signal
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
              "float64_cuda_cores": 33.5e12,  # fp64 DFMAs outside the tensor cores
              "bfloat16": 989e12,
              # fp32 products as 3xTF32: three TF32 products at 495 TFLOP/s
              "float32_3xtf32": 495e12 / 3}

S, NB, D = 58, 20480, 80  # main-path kernel shapes (T=16, 320x320, block 4x5x4)
RAGGED = [(3, 513, 80), (5, 513, 64), (2, 1, 80), (4, 100, 37), (2, 77, 128),
          (3, 45, 97)]
FP32_LIMIT = 1e-5  # max abs difference, unit-scale inputs, fp32 accumulate order
FP64_REL_LIMIT = 1e-12  # max abs difference relative to the row's l2 norm
# row ranges of the fp64 projection's sub-range checks: each starts inside
# a 64-row tile, so its rows meet other tile and fragment positions
PROJECT_SUBRANGES = [(100, 5003), (20417, 20480), (1, 2)]
# the wide routes (past D = 128: the fp64 projection, fp32 select and
# correct) at the weight checkpoint's D = 256 (train/checkpoint.py): the
# blocks of Llama-3.2-1B's largest layer-0 leaf (2048 x 8192 = 65536
# blocks; timed), and ragged shapes, D = 129 and 200 among them
WIDE = [(1, 65536, 256), (2, 513, 256), (1, 1, 256), (3, 100, 200), (2, 77, 129)]
WIDE_SEED = 300  # the seed at WIDE[0]; WIDE[i] takes WIDE_SEED + i
# sha256 of the wide routes' outputs on wide_digest_operands(*WIDE[i],
# WIDE_SEED + i) on an H100. The fp64 projection's are its first, row-tile
# build's (project_f64_wide and project_f64_wide_tma keep them). The fp32
# select's and correct's were re-pinned from the first build of
# gbatc_wide_3xtf32, which moved those routes from FFMAs to 3xTF32
# tensor-core products (a k pair's three products summed from +0, then
# added to the accumulator): they moved their last bits, within FP32_LIMIT
# of the plain version
WIDE_SHA256 = {
    (1, 65536, 256): {
        "gbatc_project_batched":
            "7e97319e26f3ec44057d74d31c63237831fa8b655cc4fa1c11e03f01bba41d17",
        "gbatc_select_accumulate":
            "66168cd105264de0fb2f559eb07513447bbfb00081b100eeb91286b16724f5ef",
        "gbatc_correct_batched":
            "f74e144311cf660b1a9e63f10898b63a7af8c28fbc9dc443ba2fbcdfe4626374",
    },
    (2, 513, 256): {
        "gbatc_project_batched":
            "214b4a0f91b8686a3d553a688b8595b9df6673dfe3649389f0ba1d6dc6a78d7c",
        "gbatc_select_accumulate":
            "e300b067b44a8e2ccbc449604309673d880c0d5b3bc6df61d09eaae8aa819ded",
        "gbatc_correct_batched":
            "25e0f8676234f2a05f6823ef55a7d0a82ae952cb19c3bc8600e0c8c1d44e3a9a",
    },
    (1, 1, 256): {
        "gbatc_project_batched":
            "bf5324c5b5870fa8821111d81ad023e5842351bed07e00f8dad4632ae7783398",
        "gbatc_select_accumulate":
            "53d258b2d93b02d6e92b215596edcbaf21072591e6c5c80052b97561f8467830",
        "gbatc_correct_batched":
            "2907f95a72e70e14dab61106212f4b719ddbf238348d6489bbcc6878c11fcb2e",
    },
    (3, 100, 200): {
        "gbatc_project_batched":
            "d09194b7c851aeb3f9a033ba7912ee96ab9b7e6f162aff50349bb47710145755",
        "gbatc_select_accumulate":
            "e2d3d8e4de8c5f032d11d5dd4458d19a96c3631e05f02ab388383d4362e0dfc0",
        "gbatc_correct_batched":
            "2fc52aca7a7f6834dd1572fa50a374d076cfa439bbaaf5851f81dca678465bff",
    },
    (2, 77, 129): {
        "gbatc_project_batched":
            "6ed2dd6a2cf45d08c6f96744e416b4ca241c1bb5cdea8cfb0bf3970326c804b5",
        "gbatc_select_accumulate":
            "a4c2fa98743dab2c6060c92e72e5db8c0d986b02830062afb8986a05003a16f0",
        "gbatc_correct_batched":
            "ca24a638f13eb9093150f83dd37c17f9e299f4ba589f8628d8d14902a9bed2e3",
    },
}
# every route at any D (the Pallas wrappers pad to any D): the reference's
# own sweep (tests/test_kernels.py), one past a 256-column slab with ragged
# rows, a 4 x 10 x 8 block, a single row, far past every panel, and the
# codec's 8 x 8 x 8 block at wide_block_path's shape (timed)
ANY_D = [(2, 513, 130), (2, 77, 257), (3, 100, 320), (1, 1, 513), (2, 65, 1000),
         (58, 1600, 512)]
ANY_D_SEED = 700  # ANY_D[i] takes ANY_D_SEED + i
ANY_D_TIMED = ANY_D[-1]
# sha256 of every route's output ("kernel/dtype") on
# wide_digest_operands(*ANY_D[i], ANY_D_SEED + i) on an H100. The fp64
# projection's are the first build of the any-D routes'; every fp32 route's
# and the fp64 select's and correct's were re-pinned from the first build of
# gbatc_wide_3xtf32 (fp32 on 3xTF32 tensor-core products) and
# gbatc_wide_dmma (fp64 on DMMA, each k step's products summed in the
# tensor cores), whose sums moved their last bits
ANY_D_SHA256 = {
    (2, 513, 130): {
        "gbatc_project_batched/float64":
            "5387260400a3cb8ec4025f51e1e2918fa345c27e7a8effd2b5660bdde23b2aa7",
        "gbatc_select_accumulate/float32":
            "cc4a5cedaa2e0a4b9d324f79411eb9489e236bf04f49c8204ba98b2781d51ac7",
        "gbatc_correct_batched/float32":
            "b9767e20d1b8386512d994bb471609cbfe03492e3a98ff7dc7aea5762827d8f7",
        "gbatc_project_batched/float32":
            "55078706ee19a8d233717978ee91a534f8fa95f4d2b9bc22f5266b2c928c6c44",
        "gbatc_select_accumulate/float64":
            "605a670d0565fae821f1b80d6dcc0ebf120c3a93726d681fb0e436dff7ba2548",
        "gbatc_correct_batched/float64":
            "7f9e343d37a6ff1bbad7b5e1301dd510906c71733955559548b99bfb31391312",
    },
    (2, 77, 257): {
        "gbatc_project_batched/float64":
            "21db5dce05123f67e170e0b8177ddfa6959b77af671cced2b7ba3ffeaa128c5b",
        "gbatc_select_accumulate/float32":
            "8dacfa28240853bcbd7d925006b78131f97db7f0b3d722d2dfa6b244dfc31259",
        "gbatc_correct_batched/float32":
            "2c57ecdb8c34bc4bf5d1d0625d526261943ec14281cd5aa70d3142589ee1fcbd",
        "gbatc_project_batched/float32":
            "f0ed8d0e380a29dda46aa955aa4329a78fead493f7dab603c5136146c9b2e389",
        "gbatc_select_accumulate/float64":
            "6e9c1368ed83c47244196bf0df4e2de72a072e37bff1791cee096b4217cc3646",
        "gbatc_correct_batched/float64":
            "245891b4dacf52bbbde23038f5c62ae5ae9014aab41790a46f7b5b9bea4379dd",
    },
    (3, 100, 320): {
        "gbatc_project_batched/float64":
            "c4241fe010b94befcc9e307ec6071089221ac87bae6a5f314f345c636ef0f9ec",
        "gbatc_select_accumulate/float32":
            "ad61cbc32bdee39b714f64f99ab944c075def5d10390310f48c2acb0897ec439",
        "gbatc_correct_batched/float32":
            "8a10f8d3fb2736ba970cf8b73a18abdc9d7d5f9a1b25fb3485ad4829a037b955",
        "gbatc_project_batched/float32":
            "6a9b62b64eb4925c00e4736d9f6ce4acafb598894ddd03a6fd105e96018dea85",
        "gbatc_select_accumulate/float64":
            "4f7e075f5ebb6143e48c8c7c15d0a7d9c4d522217dfd812cf59b2707bc524a42",
        "gbatc_correct_batched/float64":
            "3cd4d71991f33c1d7278cbee7ffc3f066c0ef672d2f11516425b559ff871f974",
    },
    (1, 1, 513): {
        "gbatc_project_batched/float64":
            "80e724faf11e5e304cca1f10b6f969b09c92368928c5b4656f361ed9ee255ce2",
        "gbatc_select_accumulate/float32":
            "dd80a33cd0ffbc0824fb025baed0b9564a326b20cbf96d32d3cc716d7af4779f",
        "gbatc_correct_batched/float32":
            "4a9302540dfb2953287795f546386d67a0d0d7dd76ca3bb8075db6bc14cb236b",
        "gbatc_project_batched/float32":
            "d99987df2ae6c16500738f7cf800f2e8ebf0874e511cad3c1fac059e60ea15f1",
        "gbatc_select_accumulate/float64":
            "6e1f5f791ff2fa91845c8296582fe99904796e30a29f335a61be258657c7582b",
        "gbatc_correct_batched/float64":
            "1f27136f96da61c00a402a69657ab09782819cd4f7af6149756b5ddfe426aad9",
    },
    (2, 65, 1000): {
        "gbatc_project_batched/float64":
            "285c47e08552aaf2132e63438073d211c5769ee37854b1d3c92d1a4724bcdf70",
        "gbatc_select_accumulate/float32":
            "6023bdfcf97b0b86be9491292de10daa3287025fd7536e24a3770d2159d9c7c8",
        "gbatc_correct_batched/float32":
            "6f70b6eb7533601ea178c57885bb884d35f19bc2f30ac68cbd06b468f145f20a",
        "gbatc_project_batched/float32":
            "e31409aab248f935b1cc6fbdc135ed45097bb5b9a8762d13dbf52a62dcb24991",
        "gbatc_select_accumulate/float64":
            "8e1534d5556860b46aacf3bb6b72bd058d30e85286e6df70852f01f3ce27f602",
        "gbatc_correct_batched/float64":
            "22251c229b814dc06182fe10330a2fa56e59ba7335a26cfd4a7eeeca83e05974",
    },
    (58, 1600, 512): {
        "gbatc_project_batched/float64":
            "1091fe3242e219234ec8cc3ab7de86e87e4927d7605295120bec7ec287660627",
        "gbatc_select_accumulate/float32":
            "f81937d5bca9b67188c203c76540cb8db427c091658a61ce20f8b58442a072c5",
        "gbatc_correct_batched/float32":
            "3d762c29520edd173801780804409452541e79b652b450e095a8de0a4b6c171d",
        "gbatc_project_batched/float32":
            "1ee6c20269d650e3516f76424e21422d741dce9128c2d31f3b8a4de594b2184a",
        "gbatc_select_accumulate/float64":
            "3b6f8ffd41343e26f537773f63471182d7d2d1debe36b25837452b2d0fec82e1",
        "gbatc_correct_batched/float64":
            "c920c0d00f79461f4ab30010d86d9032059fd56df40d1d4b7045946a7e99e71c",
    },
}
# the 2D pair past D = 128: the reference's own 130, and wide_block_path's
# blocks under one basis (timed)
GBATC_2D_ANY_D = [(513, 130), (1600, 512), (58 * 1600, 512)]
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
    # the 3xTF32 route at a ragged D (96 in DP = 128), and at D % 4 != 0
    # (element copies) with rows that have no live key
    (1, 2, 130, 130, 96, True, 0, ("float32",)),
    (2, 1, 150, 77, 37, True, 50, ("float32",)),
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
RGLRU_SWEEP = [(1, 64, 32), (2, 128, 256), (1, 100, 130),
               # the ring's edges (rglru_scan.cu's T_TILE steps a slot): one
               # step, fewer steps than a tile, one past a tile of 16, 32 or
               # 64 steps; W past a tile (160), odd (131: bf16's element
               # copies), under one 32-channel group (20); and the shape of
               # lm_serve_path's route check
               (2, 1, 64), (1, 17, 96), (2, 33, 160), (1, 65, 131), (3, 40, 20),
               (2, 2112, 2560)]
# a and b cut from buffers one element in, so their bases are not 16-byte
# aligned (the kernel's element copies, in both dtypes)
RGLRU_UNALIGNED = (2, 33, 256)
# channels of the rglru_scan sub-range checks: a range that starts inside a
# 32-channel group
RGLRU_CHANNELS = slice(33, 97)
RWKV_SWEEP = [(1, 32, 1, 16), (2, 64, 2, 32), (1, 100, 2, 64), (1, 128, 4, 64),
              (2, 37, 3, 20)]
# rows of the fp32 2D projection's sub-range checks at GBATC_2D: a range
# that starts inside a 64-row tile and ends in a ragged one, and the last
# rows of the field as one ragged tile
PROJECT_2D_SUBRANGES = [(100, 5003), (GBATC_2D[0] - 37, GBATC_2D[0])]
# rglru_scan is held bitwise to its plain version (torch.equal of h and
# h_T); its tolerance before the shared-memory ring, max abs diff at
# unit-scale inputs, is kept for the failure message
RGLRU_LIMIT = 1e-5
RWKV_LIMIT = 2e-4   # max abs diff relative to max(1, max |plain|)

# Past the kernels' old domains: flash past D = 256 (flash_wide_mma), both
# dtypes, at these (b, h, tq, tk, d, causal, window), held to FLASH_LIMIT
# and bf16_ulp_ratio <= 1, the same bits twice and for a batch or head
# sub-range where the shape has one; FLASH_WIDE_PATH, wide_head_path's
# flash chunk (4096 blocks, 1 head of 512 over 232 tokens), is timed
FLASH_WIDE = [(1, 2, 130, 130, 257, True, 0), (2, 1, 232, 232, 320, False, 0),
              (1, 1, 77, 300, 384, True, 50), (1, 2, 128, 128, 1000, True, 0)]
FLASH_WIDE_PATH = (4096, 1, 232, 512)
# sha256 of flash_wide_mma's output at every FLASH_WIDE shape and at
# FLASH_WIDE_PATH, both dtypes, on flash_wide_digests' numpy-made inputs
# (shape i from FLASH_WIDE_SEED + i; the path's from one 512-block draw,
# repeated 8 times), as the kernel's first build gave them on an H100: a
# later redesign says when it moves them
FLASH_WIDE_SEED = 960
FLASH_WIDE_SHA256 = {
    "[1, 1, 77, 300, 384, True, 50]/bfloat16":
        "4c3a7dbae9ed73bc6826b3e4bed80e52d9ee75df42f1a1176a9afc2b350a7500",
    "[1, 1, 77, 300, 384, True, 50]/float32":
        "909ee17156a87d0c160eb10af54e079b4f989f4601ddfd38d7051fbba8d1846d",
    "[1, 2, 128, 128, 1000, True, 0]/bfloat16":
        "bf946c636a52cdcaed70142f2751a1a758440420395b78ffaf96ae777e836c1c",
    "[1, 2, 128, 128, 1000, True, 0]/float32":
        "b4a74d9287f009b1eba4146b48bf77e7d988a4f53009ab4094e704c63a2a00a5",
    "[1, 2, 130, 130, 257, True, 0]/bfloat16":
        "ed345e8d22c6fb566f24730c8fc5a2abd41ea39dde6495c4a791f256d97f1b5b",
    "[1, 2, 130, 130, 257, True, 0]/float32":
        "85ad369f2da922bbdb1a78227d545cae1a06ec529ed29d479fc2b54772b0c688",
    "[2, 1, 232, 232, 320, False, 0]/bfloat16":
        "9b577191b4173375c86b217d60a5e1242b73fe8f66d5d7a99584f01a336c5f1b",
    "[2, 1, 232, 232, 320, False, 0]/float32":
        "36b152ac98fa3c04b9b364cc402bad795f24872bd4be187e793cc7a904a303c5",
    "[4096, 1, 232, 232, 512, False, 0]/bfloat16":
        "1907cfac3a0c833fe117602c32836e187323da5ea591709deb6c1f342900f18c",
    "[4096, 1, 232, 232, 512, False, 0]/float32":
        "42e8f932bea6f25a563f6e5ba7238d8acefb94b42c15d44ee420a8fac0467082",
}
# one query-tile count past the grid's 65,535 for each dtype's route at D =
# 64, with the rows a CTA of that route owns (flash_bf16_mma: 64;
# flash_f32_3xtf32: tf_rows<64> = 128): the tiles the CTAs take on their
# second pass, and the last ones, are bitwise a call of their own
FLASH_MANY_TILES = {"bfloat16": ((1, 1, 65536 * 64 + 1, 8, 64, False, 0), 64),
                    "float32": ((1, 1, 65536 * 128 + 1, 8, 64, False, 0), 128)}
# rwkv6_scan past N = 64 (rwkv6_chunked: the chunked form on the tensor
# cores, S in registers to N = 1024, in S_T's memory past it: N = 1100),
# both dtypes, with a random s0; RWKV_WIDE_PATH, RWKV-6 7B's d_model 4096
# as 32 heads of 128, and RWKV_WIDER_PATH, 16 heads of 512 (the same 21.5
# GFLOP of step-form work), are timed
RWKV_WIDE = [(1, 100, 2, 65), (2, 37, 3, 96), (1, 64, 1, 256), (2, 20, 2, 300),
             (1, 40, 2, 1100)]
RWKV_WIDE_PATH = (8, 1024, 32, 128)
RWKV_WIDER_PATH = (2, 1024, 8, 512)
RWKV_CHUNK = 16  # rwkv6_chunked's CK_C: tokens a chunk


def rwkv_chunk_flops(b, t, h, n) -> int:
    """The chunked form's matrix products (state term, update, intra) at
    RWKV_CHUNK tokens a chunk: 4 N^2 + 2 C N flops a token and head."""
    return b * t * h * (4 * n * n + 2 * RWKV_CHUNK * n)


# sha256 of rwkv6_scan's (out, S_T) at every RWKV_WIDE shape and at both
# paths, both dtypes, on rwkv_wide_digests' numpy-made inputs (shape i from
# RWKV_WIDE_SEED + i; each path's from one batch row's draw, repeated), as
# rwkv6_chunked's first build gave them on an H100: a later redesign says
# when it moves them
RWKV_WIDE_SEED = 970
RWKV_WIDE_SHA256 = {
    "[1, 100, 2, 65]/float32":
        "e923a76cd08b61e897f23a68ce10a184c18ea719767f2c72fb8b329dcda6b267",
    "[1, 100, 2, 65]/bfloat16":
        "d0f48b09dfa056edac6797658d1553416a96722aeea431924da9accb407859b2",
    "[2, 37, 3, 96]/float32":
        "77b54f739339a9a506254d857d713f2a1702f31e7e00f92b955c87cbaf666e27",
    "[2, 37, 3, 96]/bfloat16":
        "c415d141c082cefe47abe314925638d020226a516588f360dfe3f8e6e1352128",
    "[1, 64, 1, 256]/float32":
        "66fba1851dcf1121b3674e1355d573702f2e061f7d82599aa639dc85c4f0321a",
    "[1, 64, 1, 256]/bfloat16":
        "a832003b47512158bd22a6f93f045b784071864b4ee5a51b9f12958bd5d55795",
    "[2, 20, 2, 300]/float32":
        "12dad5a414d613719773219649b1ae4506066b78e61a8c3142b6f5a901a010e5",
    "[2, 20, 2, 300]/bfloat16":
        "5a85d1a3a16adc816a5a67f490d4be0fdfca31b57df667cca59161c5aa744c62",
    "[1, 40, 2, 1100]/float32":
        "2b9b3fd8fccdce051ed4f8fbbc084de7a8ffe7cda493f0501913cc5154cbf738",
    "[1, 40, 2, 1100]/bfloat16":
        "fadc66ef17052348320fb427bed1c9a4052a21648deef429f5b1fb665c36bc2c",
    "[8, 1024, 32, 128]/float32":
        "a756921c8654d49b28a8e4616d6b1ee0b6ad021ad935f266cdb64cf7da2262e2",
    "[8, 1024, 32, 128]/bfloat16":
        "74a2a16edb25a91fcc3f9ccc78f14cd01997731f7fdef47d09b655cc0bfecc0f",
    "[2, 1024, 8, 512]/float32":
        "a40d33c87ea160d833fe8288fe7775174c6ac52e651c944fb6b44068c7353007",
    "[2, 1024, 8, 512]/bfloat16":
        "88ddc1773f8aaeb0cf0c647ab867a3ed096161218cbb9a644e0cf511be5b6bd9",
}
# grids past 65,535 in y: rglru_scan's batch rows, the GBATC tile kernel's
# species (all six batched routes), and fp32 project and correct at a
# basis of 65,537 x 182 x 182 = 2.17e9 elements (8.7 GB, offsets past
# 2^31); the last row or species is bitwise its own call
RGLRU_MANY_ROWS = (65537, 3, 8)
GRID_Y_GBATC = (65537, 3, 80)
GRID_Y_GBATC_WIDE = (65537, 2, 182)

# Pins of the kernels inside their domains as they stood before flash took
# D > 256, rwkv6_scan N > 64 and every launcher a grid past 65,535 in y:
# the sha256 of each output on numpy-made inputs (old_domain_digests), as
# the build before that widening gave them on an H100. Flash at every
# FLASH_SHAPES entry, FLASH_PATH and FLASH_PIN_EXTRA (D = 80 and 256, which
# FLASH_SHAPES lacks), both dtypes; rwkv6_scan at RWKV_SWEEP and RWKV_PATH
# with a random s0 (out, S_T), both dtypes; rglru_scan at RGLRU_SWEEP with
# h0 (h, h_T), both dtypes; the tile kernel's routes (fp64 select and
# correct at D <= 128, the masked 2D pair in both dtypes) at the kernels
# phase's D <= 128 shapes. A widening moves no bit of a shape that ran, and
# the fp32 masked pair keeps these bits on correct_f32_ring.
FLASH_PIN_EXTRA = [(2, 2, 100, 130, 80, True, 0), (1, 2, 70, 90, 256, False, 0),
                   (1, 1, 130, 130, 256, True, 40)]
OLD_DOMAIN_SEED = 900
OLD_DOMAIN_SHA256 = {
    "flash_attention": {
        "[1, 1, 128, 128, 64, True, 0]/float32":
            "8b94ef33dd34d7930c379314cdd47b629a54f7cfd319f366ff20f0898d9bbff7",
        "[1, 1, 128, 128, 64, True, 0]/bfloat16":
            "d9b6856ac2e01cd21a1a9ac7835ce2ac85fd28a2b8527793ee8ec8f4abde775e",
        "[2, 3, 256, 256, 64, True, 0]/float32":
            "cdfbce519e509a12c1eb56787e83d237b3117bb017c46fba1151fdafd8ba0060",
        "[2, 3, 256, 256, 64, True, 0]/bfloat16":
            "9548bbfb94ce5e4cc3a6b3fcea663b3baa9a11b323fbbd545d9e24431fd21495",
        "[1, 2, 128, 384, 128, True, 0]/float32":
            "c2117788bcd1093fdf86142c49061c3cc17c7973820a75fa7e78614d26433408",
        "[1, 2, 128, 384, 128, True, 0]/bfloat16":
            "f46171814df0341aede4545cd8ecb2bd5fcc5914c9ea3ecc01feb8bbcee6a67e",
        "[1, 1, 200, 200, 64, True, 0]/float32":
            "870676e993bdc3d45ba0239be52d1070df9c9b9c9fde0419070f87de346be259",
        "[1, 1, 200, 200, 64, True, 0]/bfloat16":
            "f17ba48c3de552f66754461f1b6b133ccb4ac1aac21d322eaede86ec12fd8662",
        "[2, 2, 64, 64, 32, True, 0]/float32":
            "f06abd633ae2bcf5bc71cdc4c64dd58ca2acfce3a897d87e5e9324be32eb2de2",
        "[2, 2, 64, 64, 32, True, 0]/bfloat16":
            "4f852ae06b93ad21415e9fdafaa5933aa1ac9a26f86d2e2806d0e2f45f488848",
        "[1, 2, 256, 256, 64, True, 16]/float32":
            "60607d825ca33d7c9caf63136fbe92512333cb3188f016dc1d13901b8150e819",
        "[1, 2, 256, 256, 64, True, 16]/bfloat16":
            "df926b696f268b7fea1f17d95db3cdbfded75ef44d3319e948caffd03744caf1",
        "[1, 2, 256, 256, 64, True, 64]/float32":
            "c872a6b37ca3ca5f354c5d8a14eb81ea1360d28a5015b170a7fb07fdcdd458e2",
        "[1, 2, 256, 256, 64, True, 64]/bfloat16":
            "d9c7bbb3681d9d86ab79c46cb286fd4a4be8ee5fc827eb98d9cf7e381003255b",
        "[1, 2, 256, 256, 64, True, 1000]/float32":
            "6b47b9a2b270c5042d5669489aa69ff03883557cd3625abbf0ba33fcd7205e32",
        "[1, 2, 256, 256, 64, True, 1000]/bfloat16":
            "34689338a98dbed1162322213b7b6cc2e7981d6b6a4073a648797a3b711094d0",
        "[1, 1, 128, 256, 64, False, 0]/float32":
            "a82e89eb7f41092a347b65ee1680a46f24a4934dff95a44e750f1d668d2db8f0",
        "[1, 1, 128, 256, 64, False, 0]/bfloat16":
            "6185f689976cdf2d0e8ebd22fdda86945ff3ea041307f6168ea93879fef83cd5",
        "[2, 2, 232, 232, 16, False, 0]/float32":
            "afefc99ff99550503c3aa784469164b102d3dd40a159493a3a76fff643734208",
        "[2, 2, 232, 232, 16, False, 0]/bfloat16":
            "fbaa4f41d1fffcd5e4f076401748e741470fc3307e30e6a9a58bdaa5e1ed0328",
        "[3, 2, 1, 16, 16, False, 0]/float32":
            "a657191dd5ec190ca328ad6da7458a06fb3185fa39e70932372f02276f0f43e2",
        "[3, 2, 1, 16, 16, False, 0]/bfloat16":
            "99a65eb51d3b1ff9f52f618d1f98712a11afe2b6ccee31b9ef47467b3e408ade",
        "[1, 2, 100, 37, 8, False, 0]/float32":
            "9291ba7fb1c318945218b1995bd03bfbc5042465b283ba3d63f1989f58dd8ee6",
        "[1, 2, 100, 37, 8, False, 0]/bfloat16":
            "a2037d825b60f912a547fc5de0d57e49c91bc2ee65849eb865f411d07b895289",
        "[2, 1, 70, 300, 128, False, 24]/float32":
            "69f952fbdc704665e65ff58e119c8b40f3a611358b43bd5c0e33b4013f451c51",
        "[2, 1, 70, 300, 128, False, 24]/bfloat16":
            "28da58983972e5c63209938343637d5f75ec1de971363d0bb96f3a80cbf612a5",
        "[1, 2, 130, 130, 96, True, 0]/float32":
            "5640b2a1d91e6fdefd5f3560940e0f01ebe53691ba6281a861cefa93c8074b22",
        "[1, 2, 130, 130, 96, True, 0]/bfloat16":
            "15dbbdaad0017f532f2fddfcf8d7389ebdf14892babdff1a1deb6c7eec196a93",
        "[2, 1, 150, 77, 37, True, 50]/float32":
            "c3038597ad9b8667872941e80272b86afe57d0d8bb0e7ae9559d670b945efb8e",
        "[2, 1, 150, 77, 37, True, 50]/bfloat16":
            "ad312644f0dfa25be7571877bb863039f0d879186ee3fcfbd33acbd62aa82b97",
        "[2, 2, 100, 130, 80, True, 0]/float32":
            "c31beae74653f5f9c18f265f023850fddb72ab8b3639dd1e8fdad0649dc38396",
        "[2, 2, 100, 130, 80, True, 0]/bfloat16":
            "c9333eeaaa08897b871c0e021f263d5e6957c0effaa6c917928361a53148d9b8",
        "[1, 2, 70, 90, 256, False, 0]/float32":
            "169c56c064256ed79b74e703003951406ae0a80e22cb0228bc39f0ca8bc9655b",
        "[1, 2, 70, 90, 256, False, 0]/bfloat16":
            "d7f9dbac1f04be317d46cef36d3b3b9d14809bf46e82c2562518e359baa85197",
        "[1, 1, 130, 130, 256, True, 40]/float32":
            "0e070779d707a9dc04cf076430d2dac465a15b17e8fc0b89c4c6403139d4b1bf",
        "[1, 1, 130, 130, 256, True, 40]/bfloat16":
            "7dd5589e297088059c3493fa407b734b627ecc28ca25126f62ad9f98c5a6dc15",
        "[4096, 2, 232, 232, 16, False, 0]/float32":
            "d24604ce335ca1c0360f4e3cf655181e48b7cc6a78911ba49dd62acac68928d6",
        "[4096, 2, 232, 232, 16, False, 0]/bfloat16":
            "3e7e8d722fd79eaf3be3e4db4707abd010163158fd01cf276c4477ae2cde5cc7",
    },
    "rwkv6_scan": {
        "[1, 32, 1, 16]/float32":
            "05419c1173a5644bd21627ddf9a56914daa3d90d5cd58c2210141b84b8eca347",
        "[1, 32, 1, 16]/bfloat16":
            "7d6d899a890ccd0c73c809520a714d75b593bd6e158697292393c97e79af5f6b",
        "[2, 64, 2, 32]/float32":
            "0597343e378cd0c40035558fbfd41fa7ae7f41ce5da184b8afc84e51ec49a8ee",
        "[2, 64, 2, 32]/bfloat16":
            "1224b62232cbac4e9ea872593f414d5bbbb1a0cca0584d44a7986b73a8d730aa",
        "[1, 100, 2, 64]/float32":
            "17552f8d21e4d89a403030a0f404dd3fc6d1a2ec332c65db5a92fb4af0dd876e",
        "[1, 100, 2, 64]/bfloat16":
            "1f55a529e55beb3c281c76c757af40b4a3011fcc1dbc331f52d2a04bbcc0e77f",
        "[1, 128, 4, 64]/float32":
            "f37750a87b5a7cd60c3c61e75db37f56ab8b6194d98de6ef9fdaa579b048db4d",
        "[1, 128, 4, 64]/bfloat16":
            "46d1c9313e6b9814aee8bcc57d7b26e3d43cd0d6868833056b41cf59c554115e",
        "[2, 37, 3, 20]/float32":
            "b40a4706d960ca7724f602ea24c7033bf986ef6d08dba6b8fbd300fca780629b",
        "[2, 37, 3, 20]/bfloat16":
            "0b61e9c91832b367238ede62e1363ca2831bd434218bb9315df1f49f2032ed05",
        "[8, 1024, 64, 64]/float32":
            "5e4e4541eb4aa783fdb8381f2161f5550a692b0d9b4c5b9b1b3225bbf25634cb",
        "[8, 1024, 64, 64]/bfloat16":
            "87fc6dbf93a0079d44852966c9eaa23dc4ea1c7a33fbefdc51b5a749767548f2",
    },
    "rglru_scan": {
        "[1, 64, 32]/float32":
            "6de2dae84151922441e31f4693ff05e06387ad354582d9e5e963d0c3d0fe5259",
        "[1, 64, 32]/bfloat16":
            "6508d8a4467ff315245c6be1299ab5a911452ae0beadb49b53b9222b9bcf710a",
        "[2, 128, 256]/float32":
            "6f167a56abe8aa55957de1c009b5a6430c860eb97656c38028bb773584946c4b",
        "[2, 128, 256]/bfloat16":
            "7476c176262067cf2577c9d7de4c7598fb7d163580743970596c0c21ac5d2157",
        "[1, 100, 130]/float32":
            "77633b9a0eed7b4cd5a2c2b776b514d3a213e975e1d88af95a7fb84935c7c92f",
        "[1, 100, 130]/bfloat16":
            "8994307752c4ae7f9f3bc44b586183863482087278cf3fa4c17bb331d67f8783",
        "[2, 1, 64]/float32":
            "d24eb0088e9d7fd8df4af514150063ff57f564e1d42a0eb6d4fffc9f8517b45b",
        "[2, 1, 64]/bfloat16":
            "ee9f5a0fa06eb4d9f178628489cdc9bc34d98da78620a757b5d452f1d9c44516",
        "[1, 17, 96]/float32":
            "afa56a36d41d4948c1aeffaf39da225a47395e107252c350d87f18e65af69a1b",
        "[1, 17, 96]/bfloat16":
            "d9b5bcd42fb93bb0fef3ad89ab3eaa23ee803f41b77c2b8e8adc05d2c10b6034",
        "[2, 33, 160]/float32":
            "34e93f6e797843add309fbb867ea361c45188805a8a0c21bc7747736f23cfe67",
        "[2, 33, 160]/bfloat16":
            "e6711ecb6b7090ab494ac58dff14fca1b27dd336869e63077b432c463e7d2b29",
        "[1, 65, 131]/float32":
            "aa8a679c6c27e89c07878b29a438b05879b494deb52a70f23a50542ae0f6c216",
        "[1, 65, 131]/bfloat16":
            "21ea28bed2793d99a868de4beb93167a0e4160abe0121deef7461fb4013a8a95",
        "[3, 40, 20]/float32":
            "19fe7f98fd023a7c4a757513b3273603b66ff1fac36fb2f06dda4c092e25ce13",
        "[3, 40, 20]/bfloat16":
            "5b2330163630eeaece424ed1ca0ec8cce26fee4a8d6ce75c370c8bbf6b671882",
        "[2, 2112, 2560]/float32":
            "1157a30492e52ba9e7487ba3c8a0a4ea6da9c7cd0ea44a07ce6f8f6b0a5325ef",
        "[2, 2112, 2560]/bfloat16":
            "e72f152bcbc90d7f1bbc48229a092b942ba205ce22c1b8bcdd45c23401e54ec1",
    },
    "gbatc_tile": {
        "[58, 20480, 80]/gbatc_select_accumulate/float64":
            "1c2b2e36cf6416a7ea4845303ffe439ba9f21c2bf9684c93fe1a02478308a193",
        "[58, 20480, 80]/gbatc_correct_batched/float64":
            "5d1a3fd723c8376298ed3b6d886c5ca189f17bc6adba2b4fb45b1e681653322d",
        "[3, 513, 80]/gbatc_select_accumulate/float64":
            "1544b069e11669ef752d2d8faec321a0e43aec209ebc567b874f278705872ad4",
        "[3, 513, 80]/gbatc_correct_batched/float64":
            "87fe0a660dc47ffb3789be2dabf1cb65baf86ad60c97f71e7ee13fadd7cf1fc3",
        "[5, 513, 64]/gbatc_select_accumulate/float64":
            "2233f40654637271c6ccec3634d8921b48b476ffbd653a6e9a729c3b4b6dd2d9",
        "[5, 513, 64]/gbatc_correct_batched/float64":
            "1530b3bd8b04b626c813495c06ffe1589cc8b4164cce66ef887b4ff3b84f5be3",
        "[2, 1, 80]/gbatc_select_accumulate/float64":
            "b63c108b1980c4094cde07a6814a88aff12d4ec8eda1f21a4edc309baa9a8b04",
        "[2, 1, 80]/gbatc_correct_batched/float64":
            "d9ba217ae0c98ad43bbc77b5e588290733e052fefe2df14060266135159c2e15",
        "[4, 100, 37]/gbatc_select_accumulate/float64":
            "6fafa8e3f8ec573436d5218fc51d7b213d98a2958b568907d48353e0d19b8754",
        "[4, 100, 37]/gbatc_correct_batched/float64":
            "7408648844420d06c5ee8401bba2e4a5e9b16d8cefc62f10b10de95a64cc8d5c",
        "[2, 77, 128]/gbatc_select_accumulate/float64":
            "67caa7f6c1946b40a0e3e421888d429c77fe71c7880cc94534b0bf36fc4d04dc",
        "[2, 77, 128]/gbatc_correct_batched/float64":
            "d40776d8dbfb4407d0b01ad70645310d2e4109f7101b132260dffe882da239fa",
        "[3, 45, 97]/gbatc_select_accumulate/float64":
            "34f42ddea03956f7894b620b8888827787368b9aec7e86106272b4ffe3087389",
        "[3, 45, 97]/gbatc_correct_batched/float64":
            "7d4fa48315769385dc868cdf82be070cc68e0a97cbc27afac47f470006150101",
        "[100, 80]/gbatc_correct/float32":
            "911abc8ddac50a5284c3421b8f9f0f539b71630b5c4e7404b7766b703477bd0d",
        "[100, 80]/gbatc_correct/float64":
            "e079727988e1bafe7e97397eb09f92955e50a3345494877fefa6511427eeddd6",
        "[1000, 80]/gbatc_correct/float32":
            "b369ed3149da304c9a145216c9be36f001387f87f9c14d2c4bccde8788fefeb1",
        "[1000, 80]/gbatc_correct/float64":
            "b4bc0d3eed4222a9854788a002af2ade100242d94f8d167079462c0d5552663a",
        "[64, 64]/gbatc_correct/float32":
            "0a60e5dd172f9998c76e26153b464ddcad8f69102cf80085ba990842566e0fce",
        "[64, 64]/gbatc_correct/float64":
            "8581677a2fa46002b0b23e8ec3cbe250009084f934fefbc3f8f48cad409372f4",
        "[513, 80]/gbatc_correct/float32":
            "91516b7a206e69c629163e5ab4a0c15a0c0f85b6a7ce476d2618cf6824e814ea",
        "[513, 80]/gbatc_correct/float64":
            "29a8038437268d0b6fb66bdfb300d4ecfbd43a7bc3bc148fcdfa64e3b57eec5e",
        "[77, 37]/gbatc_correct/float32":
            "307ae8996ad9183dff1e48bd1f80be7e1aff7f2664456038835e17f188001018",
        "[77, 37]/gbatc_correct/float64":
            "02c1c2e76da2d776ae13c6482e9a7e5f57232af10c2ce75662b3fb2f13847631",
    },
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# every process this script starts and has not yet reaped: stopped at exit,
# on a failure and on SIGTERM alike
CHILDREN: list = []


def stop_children() -> None:
    for p in CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()
    CHILDREN.clear()


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
        r"project_f64_wideE",
        lambda m: "f64/project/wide"), (
        r"project_f64_wide_tmaE",
        lambda m: "f64/project/wide/tma"), (
        r"gbatc_wide_3xtf32ILi(\d)E",
        lambda m: "f32/{}/wide/3xtf32".format(
            ("project", "correct", "select", "masked")[int(m.group(1))])), (
        r"gbatc_wide_dmmaILi(\d)E",
        lambda m: "f64/{}/wide/dmma".format(
            ("project", "correct", "select", "masked")[int(m.group(1))]))],
    "flash_attention": [(
        r"flash_kernelIfLi(\d+)E",
        lambda m: "flash/f32/dp{}".format(m.group(1))), (
        r"flash_f32_3xtf32ILi(\d+)E",
        lambda m: "flash/f32/3xtf32/dp{}".format(m.group(1))), (
        r"flash_bf16_mmaILi(\d+)E",
        lambda m: "flash/bf16/mma/dp{}".format(m.group(1))), (
        r"flash_wide_mmaI(f|13__nv_bfloat16)Lb([01])E",
        lambda m: "flash/{}/wide/mma/{}".format("f32" if m.group(1) == "f" else "bf16",
                                                ("elem", "vec")[int(m.group(2))]))],
    "block_quant": [(
        r"block_quant_kernelI(f|13__nv_bfloat16)Li(\d+)E",
        lambda m: "block_quant/{}/v{}".format(
            "f32" if m.group(1) == "f" else "bf16", m.group(2)))],
    "rglru_scan": [(
        r"rglru_kernelI(f|13__nv_bfloat16)Li(\d)E",
        lambda m: "rglru/{}/{}".format("f32" if m.group(1) == "f" else "bf16",
                                       ("vec16", "elem")[int(m.group(2))]))],
    "rwkv6_scan": [(
        r"rwkv6_kernelI(f|13__nv_bfloat16)Li(\d+)E",
        lambda m: "rwkv6/{}/np{}".format(
            "f32" if m.group(1) == "f" else "bf16", m.group(2))), (
        r"rwkv6_chunkedI(f|13__nv_bfloat16)Li(\d+)E",
        lambda m: "rwkv6/{}/chunked/{}".format(
            "f32" if m.group(1) == "f" else "bf16",
            f"np{m.group(2)}" if m.group(2) != "0" else "s_in_memory"))],
}


def loop_counts(func: str) -> list:
    """(innermost, instructions, FFMAs, MMAs) of each loop (a backward
    branch's span of addresses) of one function of ``cuobjdump -sass``."""
    ins = sorted((int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func))
    spans = [(int(t, 16), int(a, 16)) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/[^;\n]*\bBRA\b[^;\n]*0x([0-9a-f]+)", func)
        if int(t, 16) < int(a, 16)]  # backward branches: loops
    addr = [a for a, _ in ins]
    ffma, mma = [0], [0]  # running counts over the sorted instructions
    for _, op in ins:
        ffma.append(ffma[-1] + op.startswith("FFMA"))
        mma.append(mma[-1] + op.startswith(("HMMA", "DMMA")))
    counted = []
    for lo, hi in spans:
        a, b = bisect.bisect_left(addr, lo), bisect.bisect_right(addr, hi)
        counted.append((
            not any(lo <= x and y <= hi and (x, y) != (lo, hi) for x, y in spans),
            b - a, ffma[b] - ffma[a], mma[b] - mma[a]))
    return counted


def sass_loops(build) -> dict:
    """For each kernel instantiation of PTXAS_NAMES, the instructions, FFMAs
    and tensor-core MMAs (HMMA, DMMA) of the loop that holds the most MMAs,
    an innermost one where one holds any (else the smallest of those
    holding the most: a key loop around its tile copies), or, in a kernel
    without MMAs, of the loop that holds the most FFMAs, alike; and the most
    MMAs any one loop holds (``mma_any_loop``: a kernel's main loop around
    its inner ones, as rwkv6_chunked's chunk loop). MMAs rank
    first because a division's slow path, which jumps back into the
    epilogue, reads as a loop of FFMAs (``cuobjdump -sass`` of the built
    library, one process a library, all started together); empty where
    cuobjdump is missing."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    dumps = {}
    for stem in PTXAS_NAMES:
        lib = build.build_dir() / f"lib{stem}.so"
        if os.path.isfile(tool) and lib.is_file():
            dumps[stem] = subprocess.Popen([tool, "-sass", str(lib)], text=True,
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.DEVNULL)
    loops = {}
    for stem, proc in dumps.items():
        names = PTXAS_NAMES[stem]
        sass = proc.communicate(timeout=120)[0]
        for func in re.split(r"\n\s+Function : ", sass)[1:]:
            hit = next(((m, label) for pattern, label in names
                        if (m := re.search(pattern, func.split("\n", 1)[0]))), None)
            if not hit:
                continue
            counted = loop_counts(func)
            best = None
            for unit, innermost in ((3, True), (3, False), (2, True), (2, False)):
                pool = [c for c in counted if c[unit] and (c[0] or not innermost)]
                if pool:  # the most of the unit; of equals, the smallest loop
                    best = max(pool, key=lambda c: (c[unit], -c[1]))[1:]
                    break
            if best:
                loops[hit[1](hit[0])] = {"loop_instructions": best[0],
                                         "ffma": best[1], "mma": best[2],
                                         "mma_any_loop": max(c[3] for c in counted)}
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
    # rwkv6_scan past N = 64 runs on the tensor cores: each rwkv6_chunked
    # chunk loop holds HMMAs (where cuobjdump can read the library)
    chunked = {k: info["sass_loops"].get(k, {}) for k in usage if "/chunked/" in k}
    if info["sass_loops"] and not all(v.get("mma_any_loop") for v in chunked.values()):
        fail(f"a rwkv6_chunked chunk loop has no HMMA: {chunked}")
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
               nbytes, flops, launches, err, plain_launches=None, peak=None,
               device=False, **extra):
    """One ``{"kernels": ...}`` entry: the kernel's time, its plain
    version's, the one-call library yardstick's (``lib``, or None where no
    single call computes the function), and the card's bound for the work
    (operations at ``PEAK_FLOPS[peak or dtype]``). ``plain_launches``
    times a slow plain version over fewer launches. ``device`` also times
    the kernel on the device alone (``device_ms`` beside ``ms``), for a
    kernel that can end before the host has made its next call."""
    ms = time_ms(torch, fn, launches)
    if device:
        extra = {"device_ms": device_ms(torch, fn), "timing": "ms: the median "
                 "of single CUDA-event launches; device_ms: the mean of 200 "
                 "back-to-back launches queued behind a spin kernel", **extra}
    plain_ms = (time_ms(torch, plain, plain_launches, warmup=1) if plain_launches
                else time_ms(torch, plain, launches))
    library_ms = time_ms(torch, lib, launches) if lib is not None else None
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak or dtype] * 1e3
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


def rg_bitwise(torch, rk, kref, a, bb, h0, what) -> tuple:
    """rglru_scan on (a, bb, h0) against the plain version: finite, and h
    and h_T bitwise. Returns (the max abs diff of the two, (h, h_T))."""
    h, h_last = rk.rglru_scan(a, bb, h0)
    want, want_last = kref.rglru_scan_ref(a, bb, h0)
    if not (torch.isfinite(h).all() and torch.isfinite(h_last).all()):
        fail(f"rglru_scan output is not finite ({what})")
    e = max(float((h.float() - want.float()).abs().max()) if h.numel() else 0.0,
            float((h_last - want_last).abs().max()))
    if not (torch.equal(h, want) and torch.equal(h_last, want_last)):
        fail(f"rglru_scan is not bitwise its plain version ({what}): max abs "
             f"{e:.3e}, {'within' if e <= RGLRU_LIMIT else 'past'} the old "
             f"{RGLRU_LIMIT:g} limit")
    return e, (h, h_last)


def rg_sub_ranges(torch, rk, a, bb, h0, what) -> None:
    """rglru_scan gives the same bits twice, and for batches 0-1 and for
    the channels RGLRU_CHANNELS (copied out: their first group starts
    inside one of the full call's) as the full call, in h and in h_T."""
    name = f"rglru_scan ({what}, {'h0' if h0 is not None else 'no h0'})"
    same_twice(torch, name, lambda: rk.rglru_scan(a, bb, h0))
    full = rk.rglru_scan(a, bb, h0)
    for index in ((slice(0, 2),), (Ellipsis, RGLRU_CHANNELS)):
        got = rk.rglru_scan(*(None if x is None else x[index].contiguous()
                              for x in (a, bb, h0)))
        for out, f, p in zip(("h", "h_T"), full, got):
            same_rows(torch, f"{name} {out}", f, [(index, p)])


def route_bits(torch, what: str, fn, args, full) -> None:
    """A batched route gives the same bits twice, and for row sub-ranges
    (PROJECT_SUBRANGES, clipped to NB) and species 1-2 as the full call
    ``full``: a row's bits do not depend on where the grid computes it.
    The basis is ``args``' last operand; the others are (S, NB, ...)."""
    s, nb = full.shape[:2]
    same_twice(torch, what, lambda: fn(*args))
    ranges = [(a, min(b, nb)) for a, b in PROJECT_SUBRANGES if a < nb] or [(0, nb)]
    parts = [((slice(None), slice(a, b)), fn(
        *(t[:, a:b].contiguous() for t in args[:-1]), args[-1])) for a, b in ranges]
    if s > 1:
        sp = slice(1, min(3, s))
        parts.append(((sp,), fn(*(t[sp].contiguous() for t in args))))
    same_rows(torch, what, full, parts)


def pair_bits(torch, gk, x, c, u, rank, m) -> None:
    """The select and correct modes keep one order of arithmetic in either
    dtype: select on (c, rank, m) is bitwise correct on where(rank < m, c,
    0)."""
    kept = torch.where(rank < m[..., None], c,
                       torch.zeros((), dtype=c.dtype, device=c.device))
    sel = gk.gbatc_select_accumulate(x, c, rank, m, u)
    cor = gk.gbatc_correct_batched(x, kept, u)
    if not torch.equal(sel, cor):
        fail(f"{str(x.dtype).split('.')[-1]} select differs from correct on the masked "
             f"coefficients at {tuple(x.shape)} (max abs "
             f"{float((sel - cor).abs().max()):.3e})")


def batched_checks(torch, s, nb, d, seed, err: dict) -> None:
    """Every check of the three batched kernels at (s, nb, d), on every
    (kernel, dtype) route: against its plain version (FP64_REL_LIMIT,
    FP32_LIMIT; the largest difference kept in ``err[name, dtype]``), the
    same bits twice and for row and species sub-ranges (route_bits); select
    and correct under pair_bits in both dtypes."""
    from repro_torch.kernels import gbatc_project as gk
    from repro_torch.kernels import ref as kref

    for dtype in (torch.float32, torch.float64):
        x, c, u, rank, m = make_inputs(torch, s, nb, d, dtype, seed)
        for name, args, rows in (("gbatc_project_batched", (x, u), x),
                                 ("gbatc_correct_batched", (x, c, u), c),
                                 ("gbatc_select_accumulate", (x, c, rank, m, u), c)):
            fn = getattr(gk, name)
            full = fn(*args)
            e = compare(torch, full, getattr(kref, name + "_ref")(*args), rows, dtype)
            err[name, dtype] = max(err.get((name, dtype), 0.0), e)
            route_bits(torch, f"{name} ({str(dtype).split('.')[-1]}, {(s, nb, d)})",
                       fn, args, full)
            del full
        pair_bits(torch, gk, x, c, u, rank, m)
    del x, c, u, rank, m
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# the file line of each batched kernel's pallas_call in the JAX package's
# kernels/gbatc_project.py
GBATC_LINES = {"gbatc_project_batched": 207, "gbatc_select_accumulate": 288,
               "gbatc_correct_batched": 240}
# the routes the codec paths run (and WIDE_SHA256 pins), and all six
MAIN_ROUTES = (("gbatc_project_batched", "float64"),
               ("gbatc_select_accumulate", "float32"),
               ("gbatc_correct_batched", "float32"))
ALL_ROUTES = MAIN_ROUTES + (("gbatc_project_batched", "float32"),
                            ("gbatc_select_accumulate", "float64"),
                            ("gbatc_correct_batched", "float64"))


def batched_rows(torch, shape, seed, launches, err: dict, routes=MAIN_ROUTES,
                 peak=None, **extra) -> list[dict]:
    """The batched routes timed at ``shape`` beside their plain versions,
    bounds and library yardsticks (``torch.bmm`` for the projection,
    ``torch.baddbmm`` for correct; no one call computes the select); the
    fp32 routes on the tensor cores (the projection at every D, select and
    correct past 128) are bound at the 3xTF32 rate, with the FFMA bound
    beside it (``bound_ffma_ms``), and the others at ``PEAK_FLOPS[peak]``
    where ``peak`` is given; ``max_abs_err`` is ``err``'s, from batched_checks. The projection's
    operands come from ``seed``, select's and correct's from ``seed + 1``."""
    from repro_torch.kernels import gbatc_project as gk
    from repro_torch.kernels import ref as kref

    s, nb, d = shape
    n = s * nb * d
    rows = []
    for name, dt in routes:
        dtype = getattr(torch, dt)
        size = 8 if dtype == torch.float64 else 4
        project = name == "gbatc_project_batched"
        x, c, u, rank, m = make_inputs(torch, s, nb, d, dtype, seed if project else seed + 1)
        if project:
            args, lib = (x, u), (lambda: torch.bmm(x, u))
            nbytes, flops = (2 * n + s * d * d) * size, 2 * n * d
        elif name == "gbatc_correct_batched":
            ut = u.transpose(1, 2)
            args, lib = (x, c, u), (lambda: torch.baddbmm(x, c, ut))
            nbytes, flops = (3 * n + s * d * d) * size, 2 * n * d
        else:
            kept = int((rank < m[..., None]).sum())
            args, lib = (x, c, rank, m, u), None
            nbytes = (3 * n + s * d * d) * size + (n + s * nb) * 4
            flops = 2 * kept * d
        fn, plain = getattr(gk, name), getattr(kref, name + "_ref")
        tensor_cores = dtype == torch.float32 and (project or d > 128)
        bounds = ({"peak": "float32_3xtf32",
                   "bound_ffma_ms": flops / PEAK_FLOPS["float32"] * 1e3}
                  if tensor_cores else {"peak": peak} if peak else {})
        rows.append(kernel_row(
            torch, name, "gbatc_kernels.cu",
            f"src/repro/kernels/gbatc_project.py:{GBATC_LINES[name]}",
            lambda: fn(*args), lambda: plain(*args), lib, dt, shape, nbytes, flops,
            launches, err[name, dtype],
            tolerance=("max abs diff <= 1e-12 x row l2 norm"
                       if dtype == torch.float64 else "max abs diff <= 1e-5"),
            **bounds, **extra))
        del x, c, u, rank, m, args, lib
        torch.cuda.empty_cache()
    return rows


def phase_kernels(torch, launches: int) -> tuple[list[dict], list]:
    """The batched GBATC kernels' checks and timed rows; returns (rows, the
    ANY_D shapes whose digests missed ANY_D_SHA256)."""
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
    f64_tile = phase_f64_tile_kernels(torch, launches, err)
    wide = phase_wide_kernels(torch, launches)
    any_d, missed = phase_any_d_kernels(torch, launches)
    grid_y = grid_y_gbatc(torch)
    for r in rows:
        r["wide_shapes"] = wide[r["name"]]
        r["any_d"] = any_d[r["name"]]
        r["grid_y"] = grid_y[r["name"]]
        if r["name"] in f64_tile:
            r["f64_tile"] = f64_tile[r["name"]]
    emit({"phase": "kernels", "launches_timed": launches,
          "summary": [{k: r[k] for k in ("name", "dtype", "max_abs_err", "ms",
                                         "plain_ms", "library_ms", "bound_ms")}
                      for r in rows],
          "f64_tile": f64_tile, "wide": wide, "any_d": any_d, "grid_y": grid_y})
    return rows, missed


def grid_y_gbatc(torch) -> dict:
    """Every batched route at GRID_Y_GBATC and fp32 project and correct at
    GRID_Y_GBATC_WIDE (species past the grid's 65,535 in y, the wide one at
    a basis past 2^31 elements): against the plain version (FP32_LIMIT,
    FP64_REL_LIMIT), route_bits, and species 65,535 on bitwise a call of
    their own. Operands from the card's generator, the basis N(0, 1/D) (no
    QR over 65,537 bases). Returns {kernel: {dtype: entry}}."""
    from repro_torch.kernels import gbatc_project as gk
    from repro_torch.kernels import ref as kref

    g = torch.Generator(device="cuda").manual_seed(960)
    out: dict = {}
    wide = (("gbatc_project_batched", "float32"), ("gbatc_correct_batched", "float32"))
    for shape, routes in ((GRID_Y_GBATC, ALL_ROUTES), (GRID_Y_GBATC_WIDE, wide)):
        s, nb, d = shape
        for dt in ("float32", "float64"):
            names = [name for name, r_dt in routes if r_dt == dt]
            if not names:
                continue
            t0 = time.perf_counter()
            dtype = getattr(torch, dt)
            x, c = (torch.randn(s, nb, d, generator=g, device="cuda", dtype=dtype)
                    for _ in range(2))
            u = torch.randn(s, d, d, generator=g, device="cuda", dtype=dtype)
            u /= math.sqrt(d)
            rank = torch.argsort(torch.rand(s, nb, d, generator=g, device="cuda"),
                                 dim=-1).to(torch.int32)
            m = torch.randint(0, d + 1, (s, nb), generator=g, device="cuda",
                              dtype=torch.int32)
            for name in names:
                args = {"gbatc_project_batched": (x, u),
                        "gbatc_correct_batched": (x, c, u),
                        "gbatc_select_accumulate": (x, c, rank, m, u)}[name]
                fn = getattr(gk, name)
                full = fn(*args)
                e = compare(torch, full, getattr(kref, name + "_ref")(*args),
                            x if name == "gbatc_project_batched" else c, dtype)
                what = f"{name} ({dt}, {shape})"
                route_bits(torch, what, fn, args, full)
                last = slice(65535, s)
                same_rows(torch, what, full,
                          [((last,), fn(*(a[last].contiguous() for a in args)))])
                out.setdefault(name, {})[dt] = {
                    "shape": list(shape), "max_abs_err": e,
                    "species_past_65535_bitwise": True,
                    "basis_elements": s * d * d, "seconds": time.perf_counter() - t0}
                del full
            del x, c, u, rank, m
            torch.cuda.empty_cache()
    return out


def wide_digest_operands(torch, s, nb, d, seed) -> dict:
    """Each batched route's operands at (s, nb, d), drawn on the host with
    numpy from ``seed`` (the cuts' ranks sorted stably on the card), so
    their bits hang on no library of the card's: {(kernel, dtype):
    operands}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x, c = rng.standard_normal((2, s, nb, d))
    u = rng.standard_normal((s, d, d)) / np.sqrt(d)
    keys = rng.random((s, nb, d))
    m = rng.integers(0, d + 1, (s, nb), dtype=np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    rank, m = torch.argsort(dev(keys), dim=-1, stable=True).to(torch.int32), dev(m)
    x64, c64, u64 = dev(x), dev(c), dev(u)
    x32, c32, u32 = (dev(a.astype(np.float32)) for a in (x, c, u))
    return {("gbatc_project_batched", "float64"): (x64, u64),
            ("gbatc_select_accumulate", "float32"): (x32, c32, rank, m, u32),
            ("gbatc_correct_batched", "float32"): (x32, c32, u32),
            ("gbatc_project_batched", "float32"): (x32, u32),
            ("gbatc_select_accumulate", "float64"): (x64, c64, rank, m, u64),
            ("gbatc_correct_batched", "float64"): (x64, c64, u64)}


def route_digests(torch, shapes, seed, routes) -> dict:
    """{shape: {"kernel/dtype": sha256 of its output}} on
    wide_digest_operands(*shapes[i], seed + i)."""
    from repro_torch.kernels import gbatc_project as gk

    got = {}
    for i, shape in enumerate(shapes):
        ops = wide_digest_operands(torch, *shape, seed + i)
        got[shape] = {f"{name}/{dt}": hashlib.sha256(
            getattr(gk, name)(*ops[name, dt]).cpu().numpy().tobytes()).hexdigest()
            for name, dt in routes}
        del ops
    torch.cuda.empty_cache()
    return got


def wide_digests(torch) -> dict:
    """The sha256 of each wide route's output at every WIDE shape, on
    wide_digest_operands(WIDE[i], WIDE_SEED + i); fails unless each is
    WIDE_SHA256's. Returns {kernel: digest at WIDE[0]}."""
    t0 = time.perf_counter()
    got = {shape: {k.split("/")[0]: v for k, v in digests.items()}
           for shape, digests in route_digests(torch, WIDE, WIDE_SEED, MAIN_ROUTES).items()}
    for shape in WIDE:
        if got[shape] != WIDE_SHA256[shape]:
            fail(f"the wide kernels' outputs at {shape} moved: {got[shape]} "
                 f"against {WIDE_SHA256[shape]}")
    emit({"phase": "kernels", "kernel": "wide_digests", "seed": WIDE_SEED,
          "sha256": {str(list(k)): v for k, v in got.items()},
          "equal_to_pinned": True, "seconds": time.perf_counter() - t0})
    return got[WIDE[0]]


def phase_wide_kernels(torch, launches: int) -> dict:
    """The wide routes (past D = 128) of the fp64 projection and the fp32
    select and correct under batched_checks and wide_digests at
    every WIDE shape, and timed at WIDE[0]. Returns {kernel: entry}."""
    err: dict = {}
    for i, (s, nb, d) in enumerate(WIDE):
        batched_checks(torch, s, nb, d, WIDE_SEED + i, err)
    sha = wide_digests(torch)
    out = {}
    for r in batched_rows(torch, WIDE[0], 390, launches, err, shapes_checked=WIDE):
        for k in ("route", "source", "replaces", "launches"):
            r.pop(k)
        r["sha256"] = sha[r["name"]]
        out[r.pop("name")] = r
    return out


# the tile kernel's fp64 routes, which no path launches (the engine selects
# and replays in fp32): timed at the main path's shape
F64_TILE_ROUTES = (("gbatc_select_accumulate", "float64"),
                   ("gbatc_correct_batched", "float64"))


def phase_f64_tile_kernels(torch, launches: int, err: dict) -> dict:
    """The tile kernel's fp64 correct and select at (S, NB, D), checked by
    batched_checks there (``err``), timed beside ``torch.baddbmm`` (correct;
    no one call computes the select), bound by their bytes or their DFMAs
    on the CUDA cores (33.5 TFLOP/s). Returns {kernel: entry}."""
    out = {}
    for r in batched_rows(torch, (S, NB, D), 2, launches, err, routes=F64_TILE_ROUTES,
                          peak="float64_cuda_cores"):
        for k in ("route", "source", "replaces", "launches"):
            r.pop(k)
        out[r.pop("name")] = r
    return out


def phase_any_d_kernels(torch, launches: int) -> tuple[dict, list]:
    """Every (kernel, dtype) route at every ANY_D shape under
    batched_checks; the sha256 of every route's output at every ANY_D shape
    against ANY_D_SHA256; each route timed at ANY_D_TIMED. Returns
    ({kernel: {dtype: entry}}, the shapes whose digests missed: a miss
    fails the run before its result lines)."""
    t0 = time.perf_counter()
    err: dict = {}
    for i, (s, nb, d) in enumerate(ANY_D):
        batched_checks(torch, s, nb, d, ANY_D_SEED + i, err)
    checks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = route_digests(torch, ANY_D, ANY_D_SEED, ALL_ROUTES)
    missed = [shape for shape in ANY_D if got[shape] != ANY_D_SHA256.get(shape)]
    emit({"phase": "kernels", "kernel": "any_d_digests", "seed": ANY_D_SEED,
          "sha256": {str(list(k)): v for k, v in got.items()},
          "equal_to_pinned": not missed, "missed": [list(k) for k in missed],
          "seconds": time.perf_counter() - t0, "checks_s": checks_s})
    out: dict = {}
    for r in batched_rows(torch, ANY_D_TIMED, 790, launches, err, routes=ALL_ROUTES,
                          shapes_checked=ANY_D):
        for k in ("route", "source", "replaces", "launches"):
            r.pop(k)
        r["sha256"] = got[ANY_D_TIMED][f"{r['name']}/{r['dtype']}"]
        out.setdefault(r.pop("name"), {})[r["dtype"]] = r
    return out, missed


def digest(torch, *tensors) -> str:
    """sha256 of the tensors' bytes, in order (any dtype)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def old_domain_digests(torch) -> dict:
    """{kernel: {case: sha256}} at every shape OLD_DOMAIN_SHA256 pins (see
    there); case keys name the shape and dtype. Each case draws its
    operands once, in fp32 with numpy (case i from OLD_DOMAIN_SEED + i),
    and casts them on the card to each dtype it runs."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import gbatc_project as gk
    from repro_torch.kernels import rglru_scan as rk
    from repro_torch.kernels import rwkv6_scan as wk

    out: dict = {"flash_attention": {}, "rwkv6_scan": {}, "rglru_scan": {},
                 "gbatc_tile": {}}
    seeds = iter(range(OLD_DOMAIN_SEED, OLD_DOMAIN_SEED + 1000))

    def draws():
        rng = np.random.default_rng(next(seeds))
        return rng, lambda *shape: rng.standard_normal(shape, dtype=np.float32)

    def dev(a, dtype=None):
        t = torch.from_numpy(a).cuda()
        return t if dtype is None else t.to(dtype)

    dts = (torch.float32, torch.bfloat16)
    flash = [c[:7] for c in FLASH_SHAPES] + FLASH_PIN_EXTRA + [
        FLASH_PATH[:3] + FLASH_PATH[2:] + (False, 0)]
    for case in flash:
        b, h, tq, tk, d, causal, window = case
        _, normal = draws()
        qkv = [normal(b, h, t, d) for t in (tq, tk, tk)]
        for dt in dts:
            q, k, v = (dev(a, dt) for a in qkv)
            out["flash_attention"][f"{list(case)}/{str(dt)[6:]}"] = digest(
                torch, fk.flash_attention(q, k, v, causal=causal, window=window))
            del q, k, v
    for case in RWKV_SWEEP + [RWKV_PATH]:
        b, t, h, n = case
        _, normal = draws()
        rkv = [normal(b, t, h, n) for _ in range(3)]
        w = dev(normal(b, t, h, n)).mul_(3.0).sigmoid_().clamp_(1e-6, 1 - 1e-6)
        u, s0 = 0.5 * normal(h, n), dev(normal(b, h, n, n))
        for dt in dts:
            args = [dev(a, dt) for a in rkv] + [w.to(dt), dev(u, dt), s0]
            out["rwkv6_scan"][f"{list(case)}/{str(dt)[6:]}"] = digest(
                torch, *wk.rwkv6_scan(*args))
            del args
    for case in RGLRU_SWEEP:
        b, t, w = case
        _, normal = draws()
        a, bb, h0 = dev(normal(b, t, w)).add_(2.0).sigmoid_(), normal(b, t, w), normal(b, w)
        for dt in dts:
            out["rglru_scan"][f"{list(case)}/{str(dt)[6:]}"] = digest(
                torch, *rk.rglru_scan(a.to(dt), dev(bb, dt), dev(h0)))
    for s, nb, d in [(S, NB, D)] + RAGGED:
        rng, normal = draws()
        x, c, u = (dev(normal(s, nb, d), torch.float64), dev(normal(s, nb, d), torch.float64),
                   dev(normal(s, d, d), torch.float64) / math.sqrt(d))
        # each row's energy order, as the engine ranks coefficients
        order = torch.argsort(-c.abs(), dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True).to(torch.int32)
        m = dev(rng.integers(0, d + 1, (s, nb), dtype=np.int32))
        for name, args in (("gbatc_select_accumulate", (x, c, rank, m, u)),
                           ("gbatc_correct_batched", (x, c, u))):
            out["gbatc_tile"][f"{[s, nb, d]}/{name}/float64"] = digest(
                torch, getattr(gk, name)(*args))
        del x, c, u, order, rank, m
    for nb, d in GBATC_2D_SWEEP:
        rng, normal = draws()
        x, c, u = normal(nb, d), normal(nb, d), normal(d, d) / np.float32(np.sqrt(d))
        mask = (rng.random((nb, d), dtype=np.float32) < 0.5).astype(np.float32)
        for dt in (torch.float32, torch.float64):
            out["gbatc_tile"][f"{[nb, d]}/gbatc_correct/{str(dt)[6:]}"] = digest(
                torch, gk.gbatc_correct(*(dev(a, dt) for a in (x, c, mask, u))))
    torch.cuda.empty_cache()
    return out


def phase_old_domain_pins(torch) -> list:
    """old_domain_digests against OLD_DOMAIN_SHA256; returns the cases that
    missed (a miss fails the run before its result lines)."""
    t0 = time.perf_counter()
    got = old_domain_digests(torch)
    missed = [f"{kernel}:{case}" for kernel, cases in got.items()
              for case, sha in cases.items()
              if OLD_DOMAIN_SHA256.get(kernel, {}).get(case) != sha]
    emit({"phase": "kernels", "kernel": "old_domain_digests", "seed": OLD_DOMAIN_SEED,
          "cases": {k: len(v) for k, v in got.items()},
          "equal_to_pinned": not missed, "missed": missed[:20],
          "seconds": time.perf_counter() - t0})
    return missed


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
    row["wide_heads"] = flash_wide_checks(torch, launches, check)
    emit({"phase": "kernels", "kernel": "flash_attention",
          "launches_timed": launches, "wide_heads": row["wide_heads"],
          "summary": {k: row[k] for k in ("max_abs_err", "max_abs_err_bf16",
                                          "bf16_ulp_ratio", "ms", "ms_bf16",
                                          "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")}})
    return row


def flash_wide_checks(torch, launches: int, check) -> dict:
    """flash_attention past D = 256 at every FLASH_WIDE shape and past
    65,535 query tiles (FLASH_MANY_TILES), both dtypes, through ``check``
    (phase_flash's: the plain version at FLASH_LIMIT and bf16_ulp_ratio),
    the same bits twice and for a sub-range; FLASH_WIDE_PATH timed in both
    dtypes beside SDPA at the same dtype. Returns the entry for the flash
    row."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref as kref

    g = torch.Generator(device="cuda").manual_seed(950)
    t0 = time.perf_counter()

    def qkv(b, h, tq, tk, d, dtype):
        return [torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
                for t in (tq, tk, tk)]

    def call(q, k, v, causal, window, index=Ellipsis):
        return fk.flash_attention(q[index].contiguous(), k[index].contiguous(),
                                  v[index].contiguous(), causal=causal, window=window)

    out: dict = {"shapes_checked": FLASH_WIDE, "errors": {}, "bf16_ulp_ratio": 0.0}
    got = flash_wide_digests(torch)
    missed = sorted(k for k, sha in got.items() if FLASH_WIDE_SHA256.get(k) != sha)
    out["digests"] = {"seed": FLASH_WIDE_SEED, "cases": len(got),
                      "equal_to_pinned": not missed, "missed": missed,
                      "got": {k: got[k] for k in missed}}
    for b, h, tq, tk, d, causal, window in FLASH_WIDE:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype)[6:]
            q, k, v = qkv(b, h, tq, tk, d, dtype)
            err, ratio = check(q, k, v, causal, window, dn)
            out["errors"][dn] = max(out["errors"].get(dn, 0.0), err)
            out["bf16_ulp_ratio"] = max(out["bf16_ulp_ratio"], ratio)
            what = f"flash_attention D={d} {dn}"
            same_twice(torch, what, lambda: call(q, k, v, causal, window))
            index = ((slice(1, 2),) if b > 1 else
                     (slice(None), slice(1, 2)) if h > 1 else None)
            if index is not None:
                same_rows(torch, what, call(q, k, v, causal, window),
                          [(index, call(q, k, v, causal, window, index))])
            del q, k, v
    many = {}
    for dn, ((b, h, tq, tk, d, causal, window), rows) in FLASH_MANY_TILES.items():
        q, k, v = qkv(b, h, tq, tk, d, getattr(torch, dn))
        err, ratio = check(q, k, v, causal, window, dn)
        what = f"flash_attention at {(tq + rows - 1) // rows} query tiles ({dn})"
        same_twice(torch, what, lambda: call(q, k, v, causal, window))
        # the kernels walk the last rows first: the first two tiles are the
        # ones the CTAs take on their second pass
        full = call(q, k, v, causal, window)
        same_rows(torch, what, full, [
            (rr, fk.flash_attention(q[rr].contiguous(), k, v, causal=causal,
                                    window=window))
            for rr in ((Ellipsis, slice(0, 2 * rows), slice(None)),
                       (Ellipsis, slice(65535 * rows, tq), slice(None)))])
        many[dn] = {"shape": [b, h, tq, tk, d], "query_tiles": (tq + rows - 1) // rows,
                    "rows_a_cta": rows, "max_abs_err": err, "bf16_ulp_ratio": ratio,
                    "last_tiles_bitwise": True}
        del q, k, v, full
        torch.cuda.empty_cache()
    out["many_tiles"] = many
    b, h, t, d = FLASH_WIDE_PATH
    n = b * h * t * d
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        q, k, v = qkv(b, h, t, t, d, dtype)
        err, ratio = check(q, k, v, False, 0, dn)
        what = f"flash_attention {FLASH_WIDE_PATH} {dn}"
        same_twice(torch, what, lambda: call(q, k, v, False, 0))
        # the codec encodes in 512-block batches and decodes in 4096-block ones
        same_rows(torch, what, call(q, k, v, False, 0),
                  [(slice(0, 512), call(q, k, v, False, 0, slice(0, 512)))])
        lib = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        plain = lambda: kref.flash_attention_ref(q, k, v, causal=False)  # noqa: E731
        # fp32 is held to its products' 3xTF32 bound, as at D <= 256, the
        # CUDA cores' bound beside it
        fp32 = dtype == torch.float32
        row = kernel_row(
            torch, "", "", "", lambda: fk.flash_attention(q, k, v, causal=False),
            plain, lib, dn, FLASH_WIDE_PATH, 4 * n * dtype.itemsize,
            4 * b * h * t * t * d, launches, err,
            peak="float32_3xtf32" if fp32 else None, causal=False, bf16_ulp_ratio=ratio,
            bound_ffma_ms=4 * b * h * t * t * d / PEAK_FLOPS["float32"] * 1e3,
            library_backend=sdpa_backend(torch, q, k, v),
            library_max_abs_err=float((lib().float() - plain().float()).abs().max()),
            kernel="flash_wide_mma (tensor cores: " + (
                "3xTF32)" if fp32 else "bf16, P V as a hi/lo pair)"))
        for key in ("name", "route", "source", "replaces", "launches"):
            row.pop(key)
        out[dn] = row
        del q, k, v
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def flash_wide_digests(torch) -> dict:
    """{case: sha256} of flash_attention's output at every FLASH_WIDE shape
    and at FLASH_WIDE_PATH, both dtypes (see FLASH_WIDE_SHA256). Each shape
    draws q, k, v once, in fp32 with numpy, and casts them on the card to
    each dtype; the path's operands are one 512-block draw repeated 8 times
    along the batch, and its 8 output blocks must be bitwise equal (a row's
    bits depend only on its inputs)."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fk

    out = {}

    def draw(seed, *shapes):
        rng = np.random.default_rng(seed)
        return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda()
                for s in shapes]

    for i, (b, h, tq, tk, d, causal, window) in enumerate(FLASH_WIDE):
        qkv = draw(FLASH_WIDE_SEED + i, *((b, h, t, d) for t in (tq, tk, tk)))
        for dt in (torch.float32, torch.bfloat16):
            o = fk.flash_attention(*(x.to(dt) for x in qkv), causal=causal, window=window)
            out[f"{[b, h, tq, tk, d, causal, window]}/{str(dt)[6:]}"] = digest(torch, o)
    b, h, t, d = FLASH_WIDE_PATH
    qkv = draw(FLASH_WIDE_SEED + len(FLASH_WIDE), *[(512, h, t, d)] * 3)
    for dt in (torch.float32, torch.bfloat16):
        o = fk.flash_attention(*(x.to(dt).repeat(b // 512, 1, 1, 1) for x in qkv),
                               causal=False)
        first = o[:512]
        if not all(torch.equal(first, o[j:j + 512]) for j in range(512, b, 512)):
            fail(f"flash_attention {FLASH_WIDE_PATH} {dt}: equal 512-block inputs gave "
                 "different outputs")
        out[f"{[b, h, t, t, d, False, 0]}/{str(dt)[6:]}"] = digest(torch, o)
        del o, first
    del qkv
    torch.cuda.empty_cache()
    return out


def rwkv_wide_digests(torch, scan=None) -> dict:
    """{case: sha256 of (out, S_T)} of rwkv6_scan at every RWKV_WIDE shape
    and at RWKV_WIDE_PATH and RWKV_WIDER_PATH, both dtypes (see
    RWKV_WIDE_SHA256). Each case draws r, k, v, w's logits, u and s0 once,
    in fp32 with numpy (w = sigmoid(3 x) clamped to [1e-6, 1 - 1e-6] on the
    card), and casts them to each dtype; a path's operands are one batch
    row's draw repeated along the batch, and its rows' outputs must be
    bitwise equal (a (b, h)'s bits depend only on its inputs). ``scan``
    (default: the package's ``rwkv6_scan``) takes the wrapper's operands."""
    import numpy as np

    from repro_torch.kernels import rwkv6_scan as wk

    scan = scan or wk.rwkv6_scan
    out = {}
    cases = [(shape, 1) for shape in RWKV_WIDE] + [
        ((1,) + path[1:], path[0]) for path in (RWKV_WIDE_PATH, RWKV_WIDER_PATH)]
    for i, ((b, t, h, n), rep) in enumerate(cases):
        rng = np.random.default_rng(RWKV_WIDE_SEED + i)

        def dev(*shape):
            x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
            return x.repeat(rep, *([1] * (len(shape) - 1))) if len(shape) == 4 else x

        rkv = [dev(b, t, h, n) for _ in range(3)]
        w = dev(b, t, h, n).mul_(3.0).sigmoid_().clamp_(1e-6, 1 - 1e-6)
        u, s0 = 0.5 * dev(h, n), dev(b, h, n, n)
        for dt in (torch.float32, torch.bfloat16):
            o, s_t = scan(*(x.to(dt) for x in rkv + [w, u]), s0)
            if rep > 1 and not all(torch.equal(o[:1], o[j:j + 1]) and
                                   torch.equal(s_t[:1], s_t[j:j + 1]) for j in range(1, rep)):
                fail(f"rwkv6_scan {(rep * b, t, h, n)} {dt}: equal batch rows gave "
                     "different outputs")
            out[f"{[rep * b, t, h, n]}/{str(dt)[6:]}"] = digest(torch, o, s_t)
            del o, s_t
        del rkv, w, u, s0
        torch.cuda.empty_cache()
    return out


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
    # past D = 128, both dtypes, one launch of its own counter a call
    for nb, d in GBATC_2D_ANY_D[:-1]:
        for dtype in (f32, torch.float64):
            x, c, u, mask = gbatc_inputs(nb, d, dtype)
            for kernel, call, plain, rows_of in (
                    ("gbatc_project", lambda: gk.gbatc_project(x, u),
                     lambda: kref.gbatc_project_ref(x, u), x),
                    ("gbatc_correct", lambda: gk.gbatc_correct(x, c, mask, u),
                     lambda: kref.gbatc_correct_ref(x, c, mask, u), c)):
                got, _, counts = counted(torch, call)
                if counts[kernel] != 1 or any(v for k, v in counts.items() if k != kernel):
                    fail(f"{kernel} at {(nb, d)} {dtype} launched {counts}; expected "
                         f"one launch of {kernel} and nothing else")
                e = compare(torch, got, plain(), rows_of, dtype)
                if dtype == f32:
                    err[kernel] = max(err[kernel], e)
    del x, c, u, mask
    any_d = {}
    nb, d = GBATC_2D_ANY_D[-1]
    n = nb * d
    x, c, u, mask = gbatc_inputs(nb, d, f32)
    e_p = compare(torch, gk.gbatc_project(x, u), kref.gbatc_project_ref(x, u), x, f32)
    e_c = compare(torch, gk.gbatc_correct(x, c, mask, u),
                  kref.gbatc_correct_ref(x, c, mask, u), c, f32)
    for name, fn, plain, lib, nbytes, flops, e in (
            ("gbatc_project", lambda: gk.gbatc_project(x, u),
             lambda: kref.gbatc_project_ref(x, u), lambda: torch.mm(x, u),
             (2 * n + d * d) * 4, 2 * n * d, e_p),
            ("gbatc_correct", lambda: gk.gbatc_correct(x, c, mask, u),
             lambda: kref.gbatc_correct_ref(x, c, mask, u), None,
             (4 * n + d * d) * 4, 2 * int(mask.sum()) * d, e_c)):
        # past D = 128 both run gbatc_wide_3xtf32
        r = kernel_row(torch, name, "gbatc_kernels.cu", "", fn, plain, lib, "float32",
                       (nb, d), nbytes, flops, launches, e, peak="float32_3xtf32",
                       bound_ffma_ms=flops / PEAK_FLOPS["float32"] * 1e3,
                       tolerance="max abs diff <= 1e-5")
        for k in ("name", "route", "source", "replaces", "launches"):
            r.pop(k)
        any_d[name] = {"float32": r}
    del x, c, u, mask
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
    gbatc_extra = {"shapes_checked": GBATC_2D_SWEEP + GBATC_2D_ANY_D,
                   "dtypes_checked": ["float32", "float64"],
                   "subranges_checked": PROJECT_2D_SUBRANGES,
                   "tolerance": "max abs diff <= 1e-5 (fp32); <= 1e-12 x row l2 norm (fp64)"}
    rows.append(kernel_row(
        torch, "gbatc_project", "gbatc_kernels.cu",
        "src/repro/kernels/gbatc_project.py:105",
        lambda: gk.gbatc_project(x, u), lambda: kref.gbatc_project_ref(x, u),
        lambda: torch.mm(x, u), "float32", GBATC_2D, (2 * n + d * d) * 4,
        2 * n * d, launches, max(e_p, err["gbatc_project"]), peak="float32_3xtf32",
        bound_ffma_ms=2 * n * d / PEAK_FLOPS["float32"] * 1e3,
        any_d=any_d["gbatc_project"], **gbatc_extra))
    kept = int(mask.sum())
    rows.append(kernel_row(
        torch, "gbatc_correct", "gbatc_kernels.cu",
        "src/repro/kernels/gbatc_project.py:140",
        lambda: gk.gbatc_correct(x, c, mask, u),
        lambda: kref.gbatc_correct_ref(x, c, mask, u), None, "float32",
        GBATC_2D, (4 * n + d * d) * 4, 2 * kept * d, launches,
        max(e_c, err["gbatc_correct"]), mask_kept=kept,
        any_d=any_d["gbatc_correct"], **gbatc_extra))
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

    # past N = 64: rwkv6_chunked (S in registers to N = 1024, in S_T's memory past it)
    t0 = time.perf_counter()
    wide_err = 0.0
    for b, t, h, n in RWKV_WIDE:
        for dtype in (f32, bf16):
            args = rw_inputs(b, t, h, n, dtype)
            e = rw_check(args, f"{(b, t, h, n)} {dtype}")
            wide_err = max(wide_err, e) if dtype == f32 else wide_err
            what = f"rwkv6_scan {(b, t, h, n)} {dtype}"
            same_twice(torch, what, lambda: wk.rwkv6_scan(*args))
            full = wk.rwkv6_scan(*args)
            # a batch row, and a head (u's row, s0's head), as in the full call
            parts = []
            if b > 1:
                parts.append((slice(1, 2), slice(1, 2),
                              [a if i == 4 else a[1:2] for i, a in enumerate(args)]))
            if h > 1:
                parts.append(((slice(None), slice(None), slice(1, 2)),
                              (slice(None), slice(1, 2)),
                              [a[1:2] if i == 4 else a[:, 1:2] if i == 5 else a[:, :, 1:2]
                               for i, a in enumerate(args)]))
            for out_index, s_index, sub in parts:
                got = wk.rwkv6_scan(*(a.contiguous() for a in sub))
                same_rows(torch, f"{what} out", full[0], [(out_index, got[0])])
                same_rows(torch, f"{what} S_T", full[1], [(s_index, got[1])])
            del args, full
    # decays that underflow at once, and w > 1 clamped, in the chunked form
    rw_check(rw_inputs(1, 64, 1, 128, f32, decay=1e-30, carried=False), "N = 128, w = 1e-30")
    above = rw_inputs(1, 40, 1, 96, f32, decay=1.5)
    at_one = above[:3] + (torch.ones_like(above[3]),) + above[4:]
    if not all(torch.equal(a, b) for a, b in zip(wk.rwkv6_scan(*above), wk.rwkv6_scan(*at_one))):
        fail("rwkv6_scan past N = 64 does not clamp w > 1 to 1")
    # the two timed paths: the bound is the larger of the bytes and the
    # chunked form's products at the 3xTF32 rate, the step form's FFMA
    # bound beside it
    for key, path in (("wide_heads", RWKV_WIDE_PATH), ("wider_heads", RWKV_WIDER_PATH)):
        b, t, h, n = path
        args = rw_inputs(b, t, h, n, f32)
        err = rw_check(args, f"timed shape {path}")
        wide_err = max(wide_err, err)
        same_twice(torch, f"rwkv6_scan {path}", lambda: wk.rwkv6_scan(*args))
        full = wk.rwkv6_scan(*args)
        rows_b = slice(0, 2 if b > 2 else 1)  # a batch sub-range (u has no batch)
        part = wk.rwkv6_scan(*(a if i == 4 else a[rows_b].contiguous()
                               for i, a in enumerate(args)))
        for what, f, p in zip(("out", "S_T"), full, part):
            same_rows(torch, f"rwkv6_scan ({path}, {what})", f, [(rows_b, p)])
        del full, part
        tokens = b * t * h
        np_ = -(-n // 128) * 128  # N rounded up to the kernel's panels
        cp = 16 * 8 * 128 // np_  # columns a slab (CP)
        row = kernel_row(
            torch, "", "", "", lambda: wk.rwkv6_scan(*args),
            lambda: kref.rwkv6_scan_ref(*args), None, "float32", path,
            5 * tokens * n * 4 + 2 * b * h * n * n * 4 + h * n * 4,
            rwkv_chunk_flops(b, t, h, n), launches, err, plain_launches=3,
            peak="float32_3xtf32", initial_state="random (B,H,N,N)",
            bound_ffma_ms=5 * tokens * n * n / PEAK_FLOPS["float32"] * 1e3,
            kernel=f"rwkv6_chunked<float, {np_}>: chunks of {RWKV_CHUNK} tokens "
                   f"on the tensor cores (3xTF32), {-(-n // cp)} slab(s) of {cp} "
                   "columns a (b, h)",
            tolerance="as the N <= 64 shapes")
        for k in ("name", "route", "source", "replaces", "launches"):
            row.pop(k)
        rows[-1][key] = row
        del args
    got = rwkv_wide_digests(torch)
    missed = sorted(k for k, sha in got.items() if RWKV_WIDE_SHA256.get(k) != sha)
    rows[-1]["wide_heads"].update(
        shapes_checked=RWKV_WIDE, dtypes_checked=["float32", "bfloat16"],
        subranges_checked=["batch 1", "head 1", "batch 0-1 at RWKV_WIDE_PATH",
                           "batch 0 at RWKV_WIDER_PATH"],
        max_abs_err_all=wide_err,
        digests={"seed": RWKV_WIDE_SEED, "cases": len(got), "equal_to_pinned": not missed,
                 "missed": missed, "got": {k: got[k] for k in missed}},
        seconds=time.perf_counter() - t0)

    # -- rglru_scan --------------------------------------------------------
    def rg_check(a, bb, h0, what) -> tuple:
        e, (h, _) = rg_bitwise(torch, rk, kref, a, bb, h0, what)
        return e, h

    def rg_inputs(b, t, w, dtype, offset=0):
        n = b * t * w
        return (torch.sigmoid(2.0 + randn(n + offset)).to(dtype)[offset:].view(b, t, w),
                randn(n + offset, dtype=dtype)[offset:].view(b, t, w), randn(b, w))

    rg_err = 0.0
    for b, t, w in RGLRU_SWEEP + [RGLRU_PATH]:
        for dtype in (f32, bf16):
            a, bb, h0 = rg_inputs(b, t, w, dtype)
            for init, how in ((h0, "h0"), (None, "no h0")):
                e, _ = rg_check(a, bb, init, f"{(b, t, w)} {dtype} {how}")
                rg_err = max(rg_err, e) if dtype == f32 else rg_err
            del a, bb, h0
    for dtype in (f32, bf16):
        rg_check(*rg_inputs(*RGLRU_UNALIGNED, dtype, offset=1),
                 f"{RGLRU_UNALIGNED} {dtype}, bases one element in")
    ones = torch.ones(1, 32, 16, device="cuda")
    rg_check(torch.full_like(ones, 1e-25), ones, None, "a = 1e-25")
    _, h = rg_check(torch.full_like(ones, 1.5), ones, None, "a = 1.5")
    if float(h[0, -1, 0]) != 32.0:
        fail("rglru_scan does not clamp a > 1 to 1")
    # batch rows past the grid's 65,535 in y: the rows the CTAs take on
    # their second pass are bitwise a call of their own
    b, t, w = RGLRU_MANY_ROWS
    for dtype in (f32, bf16):
        a, bb, h0 = rg_inputs(b, t, w, dtype)
        what = f"{RGLRU_MANY_ROWS} {dtype}"
        _, full = rg_bitwise(torch, rk, kref, a, bb, h0, what)
        same_twice(torch, f"rglru_scan {what}", lambda: rk.rglru_scan(a, bb, h0))
        last = slice(65535, b)
        got = rk.rglru_scan(a[last].contiguous(), bb[last].contiguous(),
                            h0[last].contiguous())
        for out, f, p in zip(("h", "h_T"), full, got):
            same_rows(torch, f"rglru_scan {what} {out}", f, [(last, p)])
        del a, bb, h0, full, got
    b, t, w = RGLRU_PATH
    for dtype in (bf16, f32):
        a, bb, h0 = rg_inputs(b, t, w, dtype)
        for init in (h0, None):
            rg_sub_ranges(torch, rk, a, bb, init, f"{RGLRU_PATH} {dtype}")
    e, _ = rg_check(a, bb, h0, "timed shape")
    n = b * t * w
    rows.append(kernel_row(
        torch, "rglru_scan", "rglru_scan.cu", "src/repro/kernels/rglru_scan.py:75",
        lambda: rk.rglru_scan(a, bb, h0), lambda: kref.rglru_scan_ref(a, bb, h0),
        None, "float32", RGLRU_PATH, 3 * n * 4 + 2 * b * w * 4, 2 * n, launches,
        max(rg_err, e), plain_launches=3, device=True, shapes_checked=RGLRU_SWEEP,
        dtypes_checked=["float32", "bfloat16"],
        extra_cases=["h0 = None at every shape", "a = 1e-25", "a = 1.5 (clamped to 1)",
                     f"{list(RGLRU_UNALIGNED)} with bases one element in",
                     f"{list(RGLRU_MANY_ROWS)}: batch rows past 65,535, the last "
                     "two bitwise their own call"],
        subranges_checked=["batch 0-1", f"channels {RGLRU_CHANNELS.start}-"
                           f"{RGLRU_CHANNELS.stop - 1}"],
        tolerance="bitwise: torch.equal of h and h_T"))
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
         lambda: kref.rglru_scan_ref(*dev(a, bb, h0)), lambda w: 0.0)  # bitwise
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


def flash_trace(torch, on: bool, out: dict, part: str):
    """A context: with ``on``, the block runs under torch.profiler (CUDA
    activity only) and ``out[part]`` gets the device seconds of the flash
    kernels in it ("not measured" where the profiler saw no device event);
    without, nothing."""
    import contextlib

    if not on:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def traced():
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        out[part] = (sum(e.time_range.elapsed_us() for e in events
                         if "flash" in e.name.lower()) / 1e6
                     if events else "not measured")

    return traced()


def drive(torch, data, cfg, args, name: str, widths: dict,
          ae_steps: int, trace_flash: bool = False) -> tuple:
    """Fit + compress at 1e-3, decompress from the bytes, a second bound on
    the same fit, with every gate of the path; returns (info, blob,
    artifact, field, codec): the path line, the 1e-3 blob, its artifact,
    its decoded field and the fitted codec. Launch counts are reset just before each of the three
    calls and read just after it. With ``trace_flash`` the compress and
    the decompress run under a CUDA-only profiler, and the line gives the
    flash kernels' device seconds in each and their share of its seconds."""
    import numpy as np

    from repro_torch import codec
    from repro_torch.core import metrics
    from repro_torch.core.pipeline import GBATCCodec

    target = 1e-3
    torch.cuda.reset_peak_memory_stats()
    gb = GBATCCodec(cfg)
    flash_s: dict = {}
    reset_counts()
    with flash_trace(torch, trace_flash, flash_s, "compress"):
        t0 = time.perf_counter()
        blob, rep = gb.compress_report(data, target_nrmse=target)
        torch.cuda.synchronize()
        compress_s = time.perf_counter() - t0
    compress_counts = all_counts()
    stage_s = json.loads(json.dumps(gb.pipeline.timings))  # deep copy
    reset_counts()
    with flash_trace(torch, trace_flash, flash_s, "decompress"):
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
        "per_species_nrmse": nrmse.tolist(),
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
    if trace_flash:
        info["flash_device_s"] = flash_s
        info["flash_share"] = {
            part: (flash_s[part] / secs if isinstance(flash_s[part], float)
                   else flash_s[part])
            for part, secs in (("compress", compress_s), ("decompress", decompress_s))}
        info["traced"] = "compress and decompress under a CUDA-only torch.profiler"
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


# wide_block_path: the conv codec at a block past every panel of the
# kernels, 8 x 8 x 8 (D = 512), on main_path's field cut to its first 8
# frames (NB = 1600 blocks a species), and one selective decode of it
WIDE_BLOCK = (8, 8, 8)
WIDE_BLOCK_FRAMES = 8
WIDE_BLOCK_SPECIES = [0, 17, 57]


def phase_wide_block_path(torch, args, data) -> dict:
    """Fit + compress + decompress at an 8 x 8 x 8 block through drive()
    (every gate of main_path: the bound after decompress(bytes), the
    decode bitwise the encoder's reconstruction, the second bound without
    a projection launch, the select backends byte for byte), then one cold
    selective decode of WIDE_BLOCK_SPECIES, bitwise the full decode's
    slice with exactly one replay launch and no other kernel."""
    import numpy as np

    from repro_torch import codec
    from repro_torch.core.blocking import BlockGeometry
    from repro_torch.core.pipeline import PipelineConfig

    field8 = np.ascontiguousarray(data[:, :WIDE_BLOCK_FRAMES])
    cfg = PipelineConfig(geometry=BlockGeometry(*WIDE_BLOCK), latent=36,
                         conv_channels=(32, 64), use_correction=True,
                         ae_steps=args.ae_steps, corr_steps=args.corr_steps,
                         seed=args.seed)
    info, blob, _, field, gb = drive(torch, field8, cfg, args, "wide_block_path", {
        "species": 58, "block": list(WIDE_BLOCK), "block_size": cfg.geometry.block_size,
        "latent": 36, "conv_channels": [32, 64], "correction": [232, 464, 232]},
        args.ae_steps)
    del gb
    info["cut"]["frames"] = WIDE_BLOCK_FRAMES
    info["nb"] = field8.shape[1] // WIDE_BLOCK[0] * (field8.shape[2] // WIDE_BLOCK[1]) \
        * (field8.shape[3] // WIDE_BLOCK[2])
    codec.clear_decode_cache()
    out, secs, counts = counted(torch, lambda: codec.decompress(
        blob, species=WIDE_BLOCK_SPECIES))
    want = sliced(field, WIDE_BLOCK_SPECIES, None)
    if out.shape != want.shape or out.dtype != want.dtype or out.tobytes() != want.tobytes():
        fail(f"wide_block_path: decompress(species={WIDE_BLOCK_SPECIES}) is not "
             "bitwise the full decode's slice")
    if counts["gbatc_correct_batched"] != 1 or any(
            n for k, n in counts.items() if k != "gbatc_correct_batched"):
        fail(f"wide_block_path: the selective decode launched {counts}; expected "
             "one gbatc_correct_batched and no other kernel")
    info["selective"] = {"species": WIDE_BLOCK_SPECIES, "cold_s": secs}
    info["launches_selective"] = counts
    emit(info)
    return info


# wide_head_path: the attention codec with one 512-wide head (arch d_model
# 512, 1 head, depth 1, MLP 1024: head dim 512, flash_wide_mma) on the first 8
# frames (10,240 blocks a species), AE steps cut (the guarantee holds
# whatever the fit), and one selective decode of it
WIDE_HEAD_ARCH = (512, 1, 1, 1024)
WIDE_HEAD_FRAMES = 8
WIDE_HEAD_AE_STEPS = 100
WIDE_HEAD_SPECIES = [2, 31, 57]


def phase_wide_head_path(torch, args, data) -> dict:
    """The attention codec at WIDE_HEAD_ARCH through drive() (every gate of
    main_path; compress and decompress traced for flash's device share),
    flash past D = 256 in compress and in decompress (the codec's one head
    dim, d_model // n_heads, is past 256, and flash was launched in both),
    then one cold selective decode of
    WIDE_HEAD_SPECIES, bitwise the full decode's slice, with one replay
    launch and flash launches only."""
    import numpy as np

    from repro_torch import codec
    from repro_torch.core.pipeline import PipelineConfig

    field8 = np.ascontiguousarray(data[:, :WIDE_HEAD_FRAMES])
    cfg = PipelineConfig(family="attention", arch=WIDE_HEAD_ARCH, latent=36,
                         use_correction=True, ae_steps=WIDE_HEAD_AE_STEPS,
                         corr_steps=args.corr_steps, seed=args.seed)
    d_model, heads, depth, mlp = cfg.arch
    if d_model // heads <= 256:
        fail(f"wide_head_path: arch {cfg.arch} has head dim {d_model // heads}, "
             "not past 256")
    info, blob, _, field, gb = drive(torch, field8, cfg, args, "wide_head_path", {
        "species": 58, "block": [4, 5, 4], "latent": 36,
        "arch": {"d_model": d_model, "n_heads": heads, "depth": depth,
                 "mlp_hidden": mlp},
        "tokens": 232, "head_dim": d_model // heads, "correction": [232, 464, 232]},
        WIDE_HEAD_AE_STEPS, trace_flash=True)
    del gb
    for part in ("compress", "decompress"):
        if info[f"launches_{part}"]["flash_attention"] < 1:
            fail(f"wide_head_path: flash_attention was never launched during {part}")
    info["cut"]["frames"] = WIDE_HEAD_FRAMES
    codec.clear_decode_cache()
    out, secs, counts = counted(torch, lambda: codec.decompress(
        blob, species=WIDE_HEAD_SPECIES))
    want = sliced(field, WIDE_HEAD_SPECIES, None)
    if out.shape != want.shape or out.dtype != want.dtype or out.tobytes() != want.tobytes():
        fail(f"wide_head_path: decompress(species={WIDE_HEAD_SPECIES}) is not "
             "bitwise the full decode's slice")
    others = {k: n for k, n in counts.items()
              if k not in ("gbatc_correct_batched", "flash_attention") and n}
    if counts["gbatc_correct_batched"] != 1 or others or counts["flash_attention"] < 1:
        fail(f"wide_head_path: the selective decode launched {counts}; expected "
             "one gbatc_correct_batched, flash_attention and no other kernel")
    info["selective"] = {"species": WIDE_HEAD_SPECIES, "cold_s": secs}
    info["launches_selective"] = counts
    emit(info)
    return info


# partial_path: the conv blob's selections (species, frame window); None
# is every species or every frame. Then PARTIAL_RANDOM seeded random pairs
# of at most PARTIAL_RANDOM_SPECIES species, so that a cold decode's host
# entropy work stays a fraction of a full decode's.
PARTIAL_SELECTIONS = [([0, 29, 57], (4, 12)), (5, None), (-1, None),
                      (None, (0, 4)), ([3], (13, 16))]
PARTIAL_RANDOM, PARTIAL_RANDOM_SPECIES = 3, 8
FLIPS_PER_REGION = 1  # seeded single-bit flips per region of the blob
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
# request (species=99). Two requests a client (16, three of them all
# species, three on the attention blob) keep the cold runs' host entropy
# work near half of three a client's.
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_MAX_BATCH = 8, 2, 32
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
        "per_species_nrmse": nrmse.tolist(),
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
# Llama-3.2-1B's self-attention (D = 64), StableLM-3B's (D = 80, its own
# instantiation in both dtypes), Yi-9B's (D = 128; Qwen3-MoE,
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
# every bf16 entry of FLASH_SHAPES; both dtypes faster than their plain
# versions, the same bits twice and for a batch sub-range
# step 2: kernel route against portable route in fp32, batch 2 and a prompt
# that crosses RecurrentGemma's 2048 window (ring buffer + window mask);
# StableLM-3B for partial RoPE at D = 80, Yi-9B for GQA at D = 128
LM_CHECK_ARCHS = ("llama3_2_1b", "stablelm_3b", "yi_9b", "rwkv6_7b",
                  "recurrentgemma_2b", "whisper_base")
LM_CHECK_BATCH, LM_CHECK_PROMPT, LM_CHECK_STEPS = 2, 2112, 4
# and two .smoke() configs widened past the kernels' old domains, d_model =
# heads x head dim: Llama with 320-wide heads (flash_wide_mma), RWKV-6 with
# 128-wide heads (rwkv6_scan's rwkv6_chunked); same batch and prompt
LM_WIDE_CHECKS = {
    "llama3_2_1b.smoke.d_head_320": ("llama3_2_1b", {"d_model": 1280, "d_head": 320}),
    "rwkv6_7b.smoke.rwkv_head_dim_128": ("rwkv6_7b", {"d_model": 256, "rwkv_head_dim": 128}),
}
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
            # fp32 at these head dims runs 3xTF32 on the tensor cores and is
            # held to that bound; the CUDA cores' bound is reported beside it
            fp32 = dtype == torch.float32
            bounds = ({"bound_ffma_ms": 4 * pairs * d / PEAK_FLOPS["float32"] * 1e3}
                      if fp32 else {})
            row = entry(
                fn, plain, lib, dn, (b, h, tq, tk, d), 2 * b * h * (tq + tk) * d * dtype.itemsize,
                4 * pairs * d, errs[dn], peak="float32_3xtf32" if fp32 else None,
                plain_launches=5,
                config=name, causal=causal, window=window, **bounds,
                live_pairs=pairs, library_backend=sdpa_backend(torch, q, k, v, **sdpa_kw),
                library_max_abs_err=float((lib().float() - plain().float()).abs().max()),
                **scale,
                tolerance=(f"max abs diff <= {FLASH_LIMIT[dn]}" + (
                    f" and |diff| <= 2^-7 |plain| + {2 * FLASH_LIMIT['float32']}"
                    " at every element" if dtype == torch.bfloat16 else "")
                    + "; ms < plain_ms"))
            out["flash_attention"].append(row)
            if row["ms"] >= row["plain_ms"]:
                fail(f"flash_attention {dn} at {name}: {row['ms']:.3f} ms, not faster "
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

    # RecurrentGemma-2B's scan at the serving shape and at the route check's
    for (b, t, wd), what in ((LM_RGLRU, "serve"),
                             ((LM_CHECK_BATCH, LM_CHECK_PROMPT, 2560), "route check")):
        a = torch.sigmoid(2.0 + torch.randn(b, t, wd, generator=g, device="cuda"))
        bb = torch.randn(b, t, wd, generator=g, device="cuda")
        h0 = torch.randn(b, wd, generator=g, device="cuda")
        err, _ = rg_bitwise(torch, rk, kref, a, bb, h0, f"{(b, t, wd)}")
        rg_sub_ranges(torch, rk, a, bb, h0, f"{(b, t, wd)}")
        nel = b * t * wd
        out["rglru_scan"].append(entry(
            lambda: rk.rglru_scan(a, bb, h0), lambda: kref.rglru_scan_ref(a, bb, h0),
            None, "float32", (b, t, wd), 3 * nel * 4 + 2 * b * wd * 4, 2 * nel, err,
            plain_launches=3, device=True, config="recurrentgemma_2b", use=what,
            tolerance="bitwise: torch.equal of h and h_T"))
        del a, bb, h0
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "lm_serve_shapes", "launches_timed": launches,
          "seconds": time.perf_counter() - t_start,
          "summary": {name: [{k: e[k] for k in ("shape", "dtype", "max_abs_err",
                                                 "bf16_ulp_ratio", "plain_max_abs",
                                                 "plain_mean_abs", "ms", "plain_ms",
                                                 "device_ms", "library_ms", "bound_ms",
                                                 "bound_by", "bound_ffma_ms")
                              if k in e}
                             for e in entries] for name, entries in out.items()}})
    return out


def _logit_gap(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def lm_route_check(torch, arch: str, totals: dict, widen: dict | None = None) -> dict:
    """Step 2 for one config: fp32 under strict_fp32, full width and depth
    (or, with ``widen``, the config's .smoke() with those fields), one
    seed's parameters through use_kernels=True and =False."""
    from repro_torch.configs.base import get_config
    from repro_torch.device import strict_fp32
    from repro_torch.models.registry import build_model, make_batch

    cfg = get_config(arch)
    if widen is not None:
        cfg = cfg.smoke().replace(**widen)
    cfg = cfg.replace(dtype=torch.float32)
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
                                                           "flash_f32_3xtf32",
                                                           "flash_bf16_mma",
                                                           "flash_wide_mma")),
                                      ("rwkv6_scan", ("rwkv6_kernel",
                                                      "rwkv6_chunked")),
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
    for name, (arch, widen) in LM_WIDE_CHECKS.items():
        routes[name] = {"widen": widen, **lm_route_check(torch, arch, totals, widen)}
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
# (12 steps of train(): one sampled block_quant check a step covers the 12
# gradient leaves, and the loss falls)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PROFILED = (
    "llama3_2_1b", 4, 2048, 12, 4)
# step 3: the same model cut to 2 of 16 layers (full width), seq 512, 6
# steps, a checkpoint every 3, one StepFailure at step 5 (a restore of
# step 3); each save of the 6.47 GB state takes about 8 s
RECOVERY = {"layers": 2, "seq": 512, "steps": 6, "save_every": 3, "fail_at": 5,
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
                           "for a restart (ROADMAP C-ref-14); train()'s 12 "
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
            # the uninterrupted run keeps no checkpoint: a save changes no
            # state, and the failing run times the saves
            mgr = (RecordingCheckpoints(os.path.join(base, name), hold=restored)
                   if hook else NoCheckpoints())
            reset_counts()
            with deterministic():
                out = train(cfg, tcfg, steps=RECOVERY["steps"], batch=TRAIN_BATCH,
                            seq=RECOVERY["seq"], ckpt=mgr, save_every=every,
                            log_every=0, device="cuda", before_step=hook)
            torch.cuda.synchronize()
            counts_are(f"recovery run ({name})", {}, totals, "lm_train_path")
            runs[name] = out
            info[name] = {"report": out["report"], "losses": out["losses"],
                          "seconds": out["seconds"], "median_step_s": out["median_step_s"]}
            if name == "failure":
                info[name].update(saves=mgr.saves, restores=mgr.restores)
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
# the children count on the host while the codec paths run (they start
# after the kernels phase, so no kernel is timed beside them), held to a
# quarter of its cores at a lower priority: the codec paths' host work
# spreads over every core, and doubled beside them on all of them
DRYRUN_CORES = max(1, len(os.sched_getaffinity(0)) // 4)
DRYRUN_NICE = 10


def dryrun_children() -> dict:
    """Gate 1's children: ``python -m repro_torch.launch.dryrun --arch <a>
    --mesh both --out <out_dir>``, one per config, all started together on
    ``DRYRUN_CORES`` of the host's cores at ``DRYRUN_NICE``; returns the
    processes, their directory, the time they were started and the cores."""
    from repro_torch.configs.base import list_configs

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_", dir=os.path.join(ROOT, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cores = sorted(os.sched_getaffinity(0))[-DRYRUN_CORES:]
    # the child sets its cores and priority before it imports anything
    boot = (f"import os, runpy, sys; os.sched_setaffinity(0, {cores}); "
            f"os.nice({DRYRUN_NICE}); sys.argv[0] = 'dryrun'; "
            "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__', "
            "alter_sys=True)")
    procs = {}
    for arch in list_configs():
        p = subprocess.Popen(
            [sys.executable, "-c", boot, "--arch", arch, "--mesh", "both", "--out", out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        CHILDREN.append(p)
        procs[arch] = p
    return {"procs": procs, "out_dir": out_dir, "started": time.perf_counter(),
            "cores": cores}


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


def phase_dryrun_path(torch, children: dict | None = None) -> dict:
    """The dry run and its two checks on the card (see the module
    docstring, step 14); returns the phase line, whose ``launches`` give
    each kernel's count over the real steps (none: the portable route).
    ``children`` are gate 1's processes from :func:`dryrun_children`,
    started earlier; without them they start here."""
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
    children = children or dryrun_children()
    procs, out_dir = children["procs"], children["out_dir"]
    info["children_head_start_s"] = max(0.0, t_start - children["started"])
    info["children_cores"] = children["cores"]
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


# phases that run in a process of their own (this script with --child),
# beside main_path to mesh_path: they take nothing from another phase (the
# wide paths generate the same seeded field again), and their device memory
# (at most about 30 GB, lm_serve_path's) fits beside those phases' (about
# 5 GB); lm_train_path (its peak is about 74 GB) runs alone
CHILD_PHASES = ("wide_block_path", "wide_head_path", "lm_serve_path")
CHILD_TIMEOUT_S = 900


def run_child(torch, args, phases: list) -> None:
    """The --child process: ``phases`` in order, each printing its lines."""
    # the backend flags the kernels phase leaves set in the starting process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = None
    if {"wide_block_path", "wide_head_path"} & set(phases):
        data, _, gen_s = generate(args)
        emit({"phase": "generate", "shape": list(data.shape), "seconds": gen_s})
    for phase in phases:
        if phase == "wide_block_path":
            phase_wide_block_path(torch, args, data)
        elif phase == "wide_head_path":
            phase_wide_head_path(torch, args, data)
        else:
            phase_lm_serve_path(torch)


def start_child(args, phases: list) -> dict:
    """Starts ``phases`` in a process of their own on the same card, with
    this run's arguments, standard output to a file in this run's build
    directory (whose libraries it loads, so nothing is compiled again);
    its standard error is this process's."""
    out = open(os.path.join(os.environ["REPRO_TORCH_BUILD_DIR"], "child.out"), "w+")
    argv = [sys.executable, os.path.abspath(__file__), "--child", ",".join(phases)]
    for name in ("launches", "frames", "height", "width", "ae_steps", "attn_ae_steps",
                 "corr_steps", "seed"):
        argv += [f"--{name.replace('_', '-')}", str(getattr(args, name))]
    p = subprocess.Popen(argv, stdout=out, cwd=ROOT)
    CHILDREN.append(p)
    return {"phases": phases, "proc": p, "out": out, "started": time.perf_counter()}


def join_child(child: dict) -> dict:
    """Waits for the child, prints its lines here and returns its phase
    lines by phase."""
    p, out, phases = child["proc"], child["out"], child["phases"]
    try:
        rc = p.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"{phases} (in a process of their own) ran past {CHILD_TIMEOUT_S} s")
    CHILDREN.remove(p)
    child["seconds"] = time.perf_counter() - child["started"]
    out.seek(0)
    text = out.read()
    out.close()
    print(text, end="", flush=True)
    if rc != 0:
        fail(f"{phases} (in a process of their own) exited {rc}")
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    got = {}
    for ln in lines:  # each phase's last line is its phase line
        if ln.get("phase") in phases:
            got[ln["phase"]] = ln
    if sorted(got) != sorted(phases):
        fail(f"the child printed phase lines of {sorted(got)}, not of {phases}")
    return got


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="env,build,kernels,main_path,attention_path,wide_block_path,"
                            "wide_head_path,ops_path,"
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
    ap.add_argument("--child",
                    help="run only these phases (of CHILD_PHASES, comma-separated), "
                         "in the build directory of the run that started this "
                         "process (see start_child)")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    import repro_torch  # noqa: F401  (fails here when run outside a checkout)

    atexit.register(stop_children)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if args.child:
        child = args.child.split(",")
        if not set(child) <= set(CHILD_PHASES):
            fail(f"--child takes phases of {CHILD_PHASES}, not {child}")
        run_child(torch, args, child)
        return

    # a fresh build directory per run: the build phase proves a build from
    # the checkout's sources every time, and a re-run never fails on (or
    # reuses) an earlier run's libraries
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    build_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    os.environ["REPRO_TORCH_BUILD_DIR"] = build_dir
    try:
        run(torch, args, phases)
    finally:
        stop_children()
        shutil.rmtree(build_dir, ignore_errors=True)


def run(torch, args, phases) -> None:
    t_start = time.perf_counter()
    walls: dict = {}  # each phase's seconds in this process, in its order

    def timed(name: str, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        return out

    if "env" in phases:
        timed("env", phase_env, torch)
    if "build" in phases:
        timed("build", phase_build)
    rows, missed, pins_missed, wide_missed, rwkv_missed = [], [], [], [], []
    if "kernels" in phases:
        t0 = time.perf_counter()
        launches = max(20, args.launches)
        batched, missed = phase_kernels(torch, launches)
        pins_missed = phase_old_domain_pins(torch)
        flash = phase_flash(torch, launches)
        wide_missed = flash["wide_heads"]["digests"]["missed"]
        ops_rows = phase_ops_kernels(torch, launches)
        # the order of PERF.md's table of TPU kernels
        rows = batched + ops_rows[:2] + [flash] + ops_rows[2:]
        rwkv_missed = next(r for r in rows if r["name"] == "rwkv6_scan")[
            "wide_heads"]["digests"]["missed"]
        lm_shapes = phase_lm_kernels(torch, launches)
        for r in rows:  # lm_serve_path's shapes beside the codec's
            if r["name"] in lm_shapes:
                r["lm_serve_shapes"] = lm_shapes[r["name"]]
        walls["kernels"] = time.perf_counter() - t0
    paths, outputs = {}, {}
    for phase in ("partial_path", "serve_path"):
        if phase in phases and not {"main_path", "attention_path"} <= set(phases):
            fail(f"{phase} needs the main_path and attention_path phases")
    for phase in ("stream_path", "mesh_path"):
        if phase in phases and "main_path" not in phases:
            fail(f"{phase} needs the main_path phase")
    if "analysis_path" in phases and not {"main_path", "attention_path"} <= set(phases):
        fail("analysis_path needs the main_path and attention_path phases")
    # no kernel is timed from here on: the dry run's children count on a
    # quarter of the host's cores, and CHILD_PHASES run in a process of their
    # own, beside main_path to mesh_path
    dry_children = dryrun_children() if "dryrun_path" in phases else None
    beside = [ph for ph in CHILD_PHASES if ph in phases]
    torch.cuda.empty_cache()
    child = start_child(args, beside) if beside else None
    data = temperature = main_codec = attention_artifact = None
    if {"main_path", "attention_path"} & set(phases):
        data, temperature, gen_s = generate(args)
        emit({"phase": "generate", "shape": list(data.shape), "seconds": gen_s})
        if "main_path" in phases:
            paths["main_path"], *outputs["main_path"], main_codec = \
                timed("main_path", phase_main_path, torch, args, data)
        if "attention_path" in phases:
            paths["attention_path"], *outputs["attention_path"], attention_artifact = \
                timed("attention_path", phase_attention_path, torch, args, data)
    ops_calls = timed("ops_path", phase_ops_path, torch) if "ops_path" in phases else {}
    partial = (timed("partial_path", phase_partial_path, torch, outputs["main_path"],
                     outputs["attention_path"])
               if "partial_path" in phases else None)
    serve = (timed("serve_path", phase_serve_path, torch, args, outputs["main_path"],
                   outputs["attention_path"])
             if "serve_path" in phases else None)
    stream = (timed("stream_path", phase_stream_path, torch, args, paths["main_path"],
                    data, temperature, outputs["main_path"][2])
              if "stream_path" in phases else None)
    # analysis_path runs last, on main_path's fit and attention_path's blob
    analysis_inputs = ((main_codec, attention_artifact)
                       if "analysis_path" in phases else None)
    attention_artifact = None
    outputs.clear()
    mesh = (timed("mesh_path", phase_mesh_path, torch, args, paths["main_path"], data,
                  main_codec)
            if "mesh_path" in phases else None)
    main_codec = None
    del data, temperature
    got = timed("beside (wait)", join_child, child) if child else {}
    for phase in ("wide_block_path", "wide_head_path"):
        if phase in got:
            paths[phase] = got[phase]
    lm = got.get("lm_serve_path")
    torch.cuda.empty_cache()
    lm_train = (timed("lm_train_path", phase_lm_train_path, torch)
                if "lm_train_path" in phases else None)
    dry = (timed("dryrun_path", phase_dryrun_path, torch, dry_children)
           if "dryrun_path" in phases else None)
    analysis = (timed("analysis_path", phase_analysis_path, torch, *analysis_inputs)
                if "analysis_path" in phases else None)
    analysis_inputs = None
    for r in rows:
        by_path = {p: {part: info[f"launches_{part}"][r["name"]]
                       for part in ("compress", "decompress", "second_compress",
                                    "selective") if f"launches_{part}" in info}
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
                                         "attention_path", "wide_block_path",
                                         "wide_head_path", "ops_path",
                                         "partial_path", "serve_path",
                                         "stream_path", "mesh_path",
                                         "lm_serve_path", "lm_train_path",
                                         "dryrun_path", "analysis_path"))
    if missed:
        fail(f"the batched routes' outputs at {missed} differ from ANY_D_SHA256's")
    if pins_missed:
        fail(f"outputs inside the kernels' old domains moved: {pins_missed[:20]} "
             "differ from OLD_DOMAIN_SHA256's")
    if wide_missed:
        fail(f"flash past D = 256 moved: {wide_missed} differ from FLASH_WIDE_SHA256's")
    if rwkv_missed:
        fail(f"rwkv6_scan past N = 64 moved: {rwkv_missed} differ from RWKV_WIDE_SHA256's")
    emit({"kernels": rows})
    print(gpu_line(), flush=True)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "phase_seconds": walls,
          "beside": {"child": {"phases": [ph for ph in CHILD_PHASES if ph in phases],
                               "seconds": child and child["seconds"]},
                     "dryrun_path": "its children, from the end of the kernels phase "
                                    f"on {DRYRUN_CORES} of the host's cores"}})
    if not complete:
        fail(f"only phases {phases} were run; the ok line needs all of them")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
