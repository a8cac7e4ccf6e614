"""Training driver: the single-controller loop with checkpointing, fault
tolerance, a straggler watchdog and optional gradient compression.

Port of the JAX package's ``launch/train.py``, with its flags plus
``--device``; runs on the GPU unless ``--device cpu`` is given (and raises
without CUDA otherwise):

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \
      --steps 200 --smoke --compress-grads --ckpt-dir build/ckpt

As in the reference, ``--smoke`` is on by default and cannot be turned off:
the command always trains the config's ``.smoke()`` size. The model runs
with ``use_kernels=False`` (no kernel has a backward; the driver says so).
Parameters are the port's own initialisation from seed 0, so the loss
trajectory is not the reference's.

:func:`train` is the loop itself, over any config: the command calls it
at the smoke size, ``chip_smoke.py`` at full width.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import build_model
from repro_torch.parallel.gradient_compression import CompressionConfig
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import Watchdog, run_with_recovery
from repro_torch.train.train_loop import (TrainConfig, init_train_state,
                                          make_train_step)


def train(cfg: ArchConfig, tcfg: TrainConfig, *, steps: int, batch: int,
          seq: int, ckpt: CheckpointManager, save_every: int = 25,
          log_every: int = 10, device: DeviceLike = None, seed: int = 0,
          before_step: Optional[Callable[[int], None]] = None) -> dict:
    """``steps`` train steps of ``cfg`` (``use_kernels`` must be False) on
    the token pipeline (vocab ``cfg.vocab``, ``batch`` x ``seq``, ``seed``)
    under :func:`run_with_recovery`, checkpointing ``{"params", "opt"}``
    (the reference's tree: the compression residuals are not saved) every
    ``save_every`` steps through ``ckpt``, from the model's initialisation
    from ``seed``; ``before_step(step)`` runs first in every step (a test
    raises :class:`StepFailure` there).

    Returns ``{"params", "state", "losses", "report", "seconds",
    "median_step_s", "step_seconds"}``; ``losses`` and ``step_seconds``
    hold one value a step run, replays included.

    As in the reference, ``run_with_recovery`` keeps the initial
    parameters and optimizer state for a restart from step 0 for the whole
    run: memory for two training states."""
    dev = resolve_device(device)
    model = build_model(cfg)
    params = model.init(seed, dev)
    step_fn = make_train_step(model, tcfg)
    state = init_train_state(model, params, tcfg)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, batch=batch,
                                             seq_len=seq, seed=seed))
    watchdog = Watchdog()
    losses = []

    def one_step(step, s):
        if before_step is not None:
            before_step(step)
        params, state = s
        batch_t = {k: torch.from_numpy(v).to(dev)
                   for k, v in pipe.batch_at(step).items()}
        params, state, metrics = step_fn(params, state, batch_t)
        losses.append(float(metrics["loss"]))
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} lr {metrics['lr']:.2e}")
        return params, state

    t0 = time.perf_counter()
    (params, state), report = run_with_recovery(
        step_fn=one_step,
        init_state=(params, state),
        n_steps=steps,
        ckpt=ckpt,
        save_every=save_every,
        watchdog=watchdog,
        state_to_tree=lambda s: {"params": s[0], "opt": s[1]["opt"]},
        tree_to_state=lambda tmpl, t: (t["params"], {**tmpl[1], "opt": t["opt"]}),
    )
    return {"params": params, "state": state, "losses": losses, "report": report,
            "seconds": time.perf_counter() - t0, "median_step_s": watchdog.median,
            "step_seconds": watchdog.times}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="build/repro_torch_ckpt")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = cfg.replace(use_kernels=False)
    print(f"{cfg.name}: use_kernels=False (no kernel has a backward; training "
          "runs the portable route)")
    tcfg = TrainConfig(
        optimizer=opt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                  warmup_steps=max(1, args.steps // 20)),
        compression=(CompressionConfig() if args.compress_grads else None),
    )
    out = train(cfg, tcfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt=CheckpointManager(args.ckpt_dir), save_every=args.save_every,
                log_every=args.log_every, device=args.device)
    losses, dt = out["losses"], out["seconds"]
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s, median {out['median_step_s']:.3f}s)")
    if losses:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; report={out['report']}")
    else:
        print(f"nothing to run: {args.ckpt_dir} already holds step "
              f"{out['report']['final_step'] - 1}; report={out['report']}")
    return losses


if __name__ == "__main__":
    main()
