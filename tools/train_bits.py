#!/usr/bin/env python3
"""Do full-width training steps repeat their bits from run to run?

Runs ``chip_smoke.py``'s full-width training cell (Llama-3.2-1B, bf16,
remat "full", batch 4 x 2048, AdamW, int8 gradient compression, through
``launch.train.train`` from seed 0) for STEPS steps four times, in turns:
under ``device.deterministic()``, without it, under it, without it. Prints
one JSON line a run (median step seconds, losses) and one a pair: whether
the two runs' final parameters and losses are bitwise equal, how many
leaves differ and by how much, and which operations warned that they have
no deterministic kernel. Needs one H100-class card and about 80 GB:

    PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True python3 tools/train_bits.py [STEPS]
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings
from contextlib import nullcontext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.device import deterministic  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.parallel.gradient_compression import CompressionConfig  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_loop import TrainConfig  # noqa: E402


def run(cfg, tcfg, steps: int, det: bool) -> tuple[dict, dict]:
    torch.cuda.empty_cache()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with deterministic() if det else nullcontext():
            t0 = time.perf_counter()
            out = train(cfg, tcfg, steps=steps, batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ,
                        ckpt=cs.NoCheckpoints(), save_every=steps, log_every=0,
                        device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    params = {k: v.detach().cpu() for k, v in out["params"].items()}
    info = {"deterministic": det, "wall_s": wall, "median_step_s": out["median_step_s"],
            "step_seconds": out["step_seconds"], "losses": out["losses"],
            "warnings": sorted({str(w.message).split("\n")[0][:300] for w in caught})}
    del out
    return info, params


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/train_bits.py: needs a CUDA device")
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    cfg = get_config(cs.TRAIN_ARCH).replace(use_kernels=False, remat="full")
    tcfg = TrainConfig(optimizer=opt.AdamWConfig(lr=3e-4, warmup_steps=4,
                                                 total_steps=cs.TRAIN_STEPS,
                                                 grad_clip=1.0),
                       compression=CompressionConfig())
    print(cs.gpu_line(), flush=True)
    runs = []
    for det in (True, False, True, False):
        info, params = run(cfg, tcfg, steps, det)
        runs.append((info, params))
        print(json.dumps({k: info[k] for k in ("deterministic", "wall_s",
                                                "median_step_s", "losses")}), flush=True)
    for det in (True, False):
        (a, pa), (b, pb) = [r for r in runs if r[0]["deterministic"] == det]
        diff = {k: float((pa[k].float() - pb[k].float()).abs().max())
                for k in pa if not torch.equal(pa[k], pb[k])}
        print(json.dumps({"deterministic": det, "params_bitwise": not diff,
                          "leaves_differing": len(diff), "leaves": len(pa),
                          "max_abs_diff": max(diff.values(), default=0.0),
                          "losses_bitwise": a["losses"] == b["losses"],
                          "median_step_s": [a["median_step_s"], b["median_step_s"]],
                          "step_seconds": [a["step_seconds"], b["step_seconds"]],
                          "warnings": sorted(set(a["warnings"]) | set(b["warnings"]))}),
              flush=True)


if __name__ == "__main__":
    main()
