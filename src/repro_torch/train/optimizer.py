"""AdamW (+ warmup/cosine schedule, global-norm clipping), written out.

The reference's recipe exactly, which ``torch.optim.AdamW`` plus a
scheduler does not reproduce: gradients are clipped by their global norm
(floor ``1e-12`` on the norm), moments are fp32, both bias corrections are
applied, ``eps`` is added **outside** the square root, weight decay (off
by default) is added to the update, and the learning rate warms up
linearly and then follows a cosine to ``min_lr_frac * lr``.

Parameters, gradients and moments are flat ``dict[str, Tensor]`` (a
``state_dict`` without buffers). The step count and the scalar schedule
live on the host — the schedule is evaluated in float32 like the
reference's — so a step costs no device synchronisation.

:func:`update` is functional (its inputs are left as they were, which is
what a caller that restarts from its last state needs); :func:`update_`
is the same step written into the parameters and moments it is given,
the counterpart of the reference's donated carries, for a trainer that
owns its state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    # warmup + cosine decay (steps); lr constant if total_steps == 0
    warmup_steps: int = 0
    total_steps: int = 0
    min_lr_frac: float = 0.1


def adamw_cfg(lr: float, steps: int) -> AdamWConfig:
    """The trainers' AdamW recipe: cosine schedule over the step budget
    with a short warmup."""
    return AdamWConfig(lr=lr, total_steps=steps,
                       warmup_steps=min(20, steps // 10))


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup then cosine decay to ``min_lr_frac * lr``, in float32."""
    f = np.float32
    if cfg.total_steps <= 0:
        return float(f(cfg.lr))
    step = f(step)
    warm = min(f(1.0), step / max(f(1.0), f(cfg.warmup_steps)))
    frac = np.clip(
        (step - f(cfg.warmup_steps))
        / max(f(1.0), f(cfg.total_steps - cfg.warmup_steps)),
        f(0.0), f(1.0),
    )
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * frac, dtype=f))
    decayed = f(cfg.min_lr_frac) + (f(1.0) - f(cfg.min_lr_frac)) * cos
    return float(f(cfg.lr) * warm * decayed)


def init_state(params: dict[str, torch.Tensor]) -> dict[str, Any]:
    return {
        "m": {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in params.items()},
        "step": 0,
    }


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def _prologue(cfg: AdamWConfig, grads, state):
    """Step count, clipped gradients, global norm, learning rate and the
    two bias corrections of the next step."""
    step = int(state["step"]) + 1
    if cfg.grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    f = np.float32
    b1c = float(f(1.0) - f(cfg.b1) ** f(step))
    b2c = float(f(1.0) - f(cfg.b2) ** f(step))
    return step, grads, gnorm, schedule(cfg, step), b1c, b2c


def _leaf_(cfg: AdamWConfig, p, m, v, g, lr: float, b1c: float, b2c: float):
    """One leaf's update, written into ``p``, ``m`` and ``v``."""
    g32 = g.float()
    m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g32)
    v.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g32))
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if cfg.weight_decay:
        delta = delta + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * delta)


def update(cfg: AdamWConfig, grads, state, params):
    """One AdamW step. Returns ``(new_params, new_state, metrics)``; the
    inputs are left untouched (each leaf is updated in a fresh copy)."""
    step, grads, gnorm, lr, b1c, b2c = _prologue(cfg, grads, state)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        new_p[k], new_m[k], new_v[k] = (p.clone(), state["m"][k].clone(),
                                        state["v"][k].clone())
        _leaf_(cfg, new_p[k], new_m[k], new_v[k], grads[k], lr, b1c, b2c)
    new_state = {"m": new_m, "v": new_v, "step": step}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}


def update_(cfg: AdamWConfig, grads, state, params):
    """:func:`update` written into ``params`` and ``state``'s moments (and
    its step count). Returns ``(params, state, metrics)``, the objects
    given."""
    step, grads, gnorm, lr, b1c, b2c = _prologue(cfg, grads, state)
    for k, p in params.items():
        _leaf_(cfg, p, state["m"][k], state["v"][k], grads[k], lr, b1c, b2c)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
