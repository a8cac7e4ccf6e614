"""The mini-batch trainer behind ``autoencoder.fit`` and ``correction.fit``.

On one device the data set is moved to the device once; each step gathers
the same random rows from every data array with indices drawn **on the
device** from a seeded ``torch.Generator``; losses stay on the device and
are fetched once at the end (``log_every`` is the only other
synchronisation, and only when asked for). The optimiser is the written-out
AdamW of :mod:`repro_torch.train.optimizer`.

The reference draws its batches from another generator, so the same seed
gives another batch stream here. ``indices=`` takes a ``(steps, batch)``
matrix instead — the tests feed the reference's own index matrix through
both trainers to compare trajectories.

``fit(mesh=...)`` is the data-parallel mode over a
:class:`~repro_torch.parallel.Mesh` (:func:`repro_torch.parallel.mesh_fit.
dp_fit`); on a 1-device mesh it is the plain loop on that device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, strict_fp32
from repro_torch.train import optimizer as opt

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
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = self._loss_fn(leaves, *batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves.keys(), grads))

    def step(self, params, state, batch):
        """One training step: loss, gradients, AdamW update."""
        loss, grads = self.loss_and_grads(params, batch)
        with torch.no_grad():
            params, state, _ = opt.update(self._ocfg, grads, state, params)
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
        params = {k: p.detach().to(dev) for k, p in params.items()}
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
