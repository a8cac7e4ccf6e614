"""Train/serve step factories of the language models, and the mini-batch
trainer behind ``autoencoder.fit`` and ``correction.fit``.

``make_train_step`` closes over (model, :class:`TrainConfig`) and returns
``(params, state, batch) -> (params, state, metrics)``: the loss and its
gradients (``torch.autograd.grad``, accumulated over ``grad_accum``
microbatches), the error-feedback gradient compression when it is on, and
the AdamW update, over the port's flat parameter dicts. No kernel has a
backward, so a model whose ``cfg.use_kernels`` is True is refused: the
step trains through the portable route only. The compression and the
update run under ``torch.profiler.record_function`` ranges
(``train_step/compress_tree``, ``train_step/adamw``), which split a
profiler trace of the step.

On one device the data set is moved to the device once; each step gathers
the same random rows from every data array with indices drawn **on the
device** from a seeded ``torch.Generator``; losses stay on the device and
are fetched once at the end (``log_every`` is the only other
synchronisation, and only when asked for). The optimiser is the written-out
AdamW of :mod:`repro_torch.train.optimizer`, applied in place
(``update_``) to the trainer's own copy of the parameters and moments, so
a step allocates no new carries.

The reference draws its batches from another generator, so the same seed
gives another batch stream here. ``indices=`` takes a ``(steps, batch)``
matrix instead — the tests feed the reference's own index matrix through
both trainers to compare trajectories.

``fit(mesh=...)`` is the data-parallel mode over a
:class:`~repro_torch.parallel.Mesh` (:func:`repro_torch.parallel.mesh_fit.
dp_fit`); on a 1-device mesh it is the plain loop on that device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, strict_fp32
from repro_torch.parallel import gradient_compression as gc
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    compression: Optional[gc.CompressionConfig] = None
    # microbatch accumulation (1 = none); the batch axis must divide
    grad_accum: int = 1


def init_train_state(model, params, train_cfg: TrainConfig) -> dict[str, Any]:
    del model
    state: dict[str, Any] = {"opt": opt.init_state(params)}
    if train_cfg.compression and train_cfg.compression.enabled:
        state["residuals"] = gc.init_residuals(params)
    return state


def loss_and_grads(loss_fn, params, *args):
    """``loss_fn(params, *args)`` and its gradient with respect to every
    parameter (zeros where the loss does not reach one, as ``jax.grad``),
    detached: no graph, no ``requires_grad``."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = loss_fn(leaves, *args)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(leaves.items(), grads)}


def make_train_step(model, train_cfg: TrainConfig):
    """The whole step as one function (see the module docstring)."""
    if model.cfg.use_kernels:
        raise ValueError(
            f"{model.cfg.name}: use_kernels=True routes the forward through "
            "kernels with no backward; train with cfg.replace(use_kernels=False)")
    ocfg, ccfg = train_cfg.optimizer, train_cfg.compression

    def train_step(params, state, batch):
        loss, grads = _accumulated(params, batch)
        new_state = dict(state)
        with torch.no_grad():
            if ccfg and ccfg.enabled:
                with torch.profiler.record_function("train_step/compress_tree"):
                    grads, new_state["residuals"] = gc.compress_tree(
                        grads, state["residuals"], ccfg)
            with torch.profiler.record_function("train_step/adamw"):
                params, new_state["opt"], om = opt.update(ocfg, grads, state["opt"],
                                                          params)
        return params, new_state, {"loss": loss, **om}

    def _accumulated(params, batch):
        n = train_cfg.grad_accum
        if n > 1:
            # unrolled accumulation: each microbatch's activations are freed
            # before the next one runs
            micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            for i in range(n):
                l_i, g_i = loss_and_grads(model.loss, params,
                                          {k: v[i] for k, v in micro.items()})
                loss = loss + l_i / n
                grads = {k: a + g_i[k] / n for k, a in grads.items()}
            return loss, grads
        return loss_and_grads(model.loss, params, batch)

    return train_step


def make_prefill_step(model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_serve_step(model):
    def serve_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return serve_step


# ---------------------------------------------------------------------------
# mini-batch SGD engine (the codec trainer hot loop)
# ---------------------------------------------------------------------------

_BATCH_SALT = 0x5CA1AB1E  # folds the batch stream away from the init seed


def batch_generator(seed: int, device: torch.device) -> torch.Generator:
    """Generator of the batch-index stream for a given fit seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 32) ^ _BATCH_SALT)
    return g


class MiniBatchTrainer:
    """Mini-batch AdamW over ``loss_fn(params, *batch_arrays)``.

    ``params`` is a flat ``dict[str, Tensor]``; ``data`` passed to
    :meth:`fit` is a tuple of arrays sharing the leading (instance) axis.
    ``ocfg.total_steps`` drives the cosine schedule, so a trainer is
    specific to its step budget.
    """

    def __init__(self, loss_fn: Callable, ocfg: opt.AdamWConfig, *,
                 log_fn: Optional[Callable[[int, float], None]] = None):
        self._loss_fn = loss_fn
        self._ocfg = ocfg
        self._log_fn = log_fn or (
            lambda t, loss: print(f"[fit] step {t} loss {loss:.3e}")
        )
        self.last_replicas: Optional[list] = None

    def loss_and_grads(self, params, batch):
        """The loss (detached) and the gradients of every parameter."""
        return loss_and_grads(self._loss_fn, params, *batch)

    def step(self, params, state, batch):
        """One training step: loss, gradients, AdamW update, written into
        ``params`` and ``state`` (:func:`~repro_torch.train.optimizer.update_`:
        the carries keep their storage from step to step). Returns
        ``(params, state, loss)``."""
        loss, grads = self.loss_and_grads(params, batch)
        with torch.no_grad():
            opt.update_(self._ocfg, grads, state, params)
        return params, state, loss

    def fit(self, params, data, *, steps: int, batch_size: int, seed: int,
            log_every: int = 0, indices=None, device: DeviceLike = None,
            mesh=None, quantized_exchange: bool = False):
        """Run ``steps`` updates; returns ``(params, losses)`` with the
        parameters on the device and the fp32 loss history on the host.

        ``mesh`` switches to the data-parallel mode (a data array may then
        also be a list of its row shards, one a mesh device). The global
        rows are trimmed to a multiple ``n`` of the mesh size ``P`` and the
        batch to ``max((bs // P) * P, P)``; shard ``i`` owns rows ``[i n /
        P, (i + 1) n / P)``; gradients are exchanged as ``psum / P``,
        int8-quantised on the ``block_quant`` kernel with
        ``quantized_exchange``; ``indices`` is then a ``(P, steps, bs /
        P)`` matrix. On a 1-device mesh this is the plain loop on that
        device (``quantized_exchange`` has nothing to exchange), bitwise
        the plain fit. The replicas of the last mesh fit stay in
        ``last_replicas``."""
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.devices[0]}")
            if mesh.size > 1:
                return self._fit_mesh(
                    params, data, steps=steps, batch_size=batch_size, seed=seed,
                    log_every=log_every, indices=indices, mesh=mesh,
                    quantized_exchange=quantized_exchange)
            data = tuple(a[0] if isinstance(a, (list, tuple)) else a for a in data)
            device = mesh.devices[0]
        dev = resolve_device(device)
        data = tuple(
            (torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
             else a).to(dev) for a in data
        )
        n = data[0].shape[0]
        bs = min(batch_size, n)
        # a copy even on the same device: the steps write into it
        params = {k: p.detach().to(dev, copy=True) for k, p in params.items()}
        state = opt.init_state(params)
        if indices is not None:
            indices = torch.tensor(np.asarray(indices), dtype=torch.int64,
                                   device=dev)
            if indices.shape[0] != steps:
                raise ValueError(
                    f"indices has {indices.shape[0]} rows for {steps} steps")
        else:
            gen = batch_generator(seed, dev)
        losses = []
        with strict_fp32():
            for t in range(steps):
                if indices is not None:
                    idx = indices[t]
                else:
                    idx = torch.randint(0, n, (bs,), generator=gen, device=dev)
                batch = tuple(a[idx] for a in data)
                params, state, loss = self.step(params, state, batch)
                losses.append(loss)
                if log_every and t % log_every == 0:
                    self._log_fn(t, float(loss))
        hist = (torch.stack(losses).float().cpu().numpy() if losses
                else np.zeros(0, np.float32))
        return params, hist

    def _fit_mesh(self, params, data, *, steps, batch_size, seed, log_every,
                  indices, mesh, quantized_exchange):
        from repro_torch.parallel import as_tensor, mesh_fit, shard_rows

        n_p = mesh.size
        sharded = [isinstance(a, (list, tuple)) for a in data]
        if any(sharded):
            if not all(sharded):
                raise ValueError("data arrays must be all sharded or all whole")
            for parts in data:
                if (len(parts) != n_p
                        or len({int(p.shape[0]) for p in parts}) != 1
                        or any(p.device != d for p, d in zip(parts, mesh.devices))):
                    raise ValueError(
                        f"sharded data must be {n_p} equal row shards on the "
                        "mesh's devices, in order")
            n = n_p * int(data[0][0].shape[0])
            shards = [tuple(parts[i] for parts in data) for i in range(n_p)]
        else:
            data = tuple(as_tensor(a) for a in data)
            n0 = int(data[0].shape[0])
            n = (n0 // n_p) * n_p  # equal per-shard row counts
            if n == 0:
                raise ValueError(f"{n0} rows cannot shard over {n_p} devices")
            per_array = [shard_rows(a[:n], mesh) for a in data]
            shards = [tuple(p[i] for p in per_array) for i in range(n_p)]
        bs = min(batch_size, n)
        bs = max((bs // n_p) * n_p, n_p)
        self.last_replicas, losses = mesh_fit.dp_fit(
            self, params, shards, steps=steps, n=n, bs=bs, seed=seed,
            log_every=log_every, mesh=mesh, quantized=quantized_exchange,
            indices=indices)
        return self.last_replicas[0], losses
