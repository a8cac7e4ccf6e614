"""The mini-batch trainer behind ``autoencoder.fit`` and ``correction.fit``.

Single device. The data set is moved to the device once; each step gathers
the same random rows from every data array with indices drawn **on the
device** from a seeded ``torch.Generator``; losses stay on the device and
are fetched once at the end (``log_every`` is the only other
synchronisation, and only when asked for). The optimiser is the written-out
AdamW of :mod:`repro_torch.train.optimizer`.

The reference draws its batches from another generator, so the same seed
gives another batch stream here. ``indices=`` takes a ``(steps, batch)``
matrix instead — the tests feed the reference's own index matrix through
both trainers to compare trajectories.
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

    def step(self, params, state, batch):
        """One training step: loss, gradients, AdamW update."""
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = self._loss_fn(leaves, *batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves.keys(), grads))
        with torch.no_grad():
            params, state, _ = opt.update(self._ocfg, grads, state, params)
        return params, state, loss.detach()

    def fit(self, params, data, *, steps: int, batch_size: int, seed: int,
            log_every: int = 0, indices=None, device: DeviceLike = None):
        """Run ``steps`` updates; returns ``(params, losses)`` with the
        parameters on the device and the fp32 loss history on the host."""
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
