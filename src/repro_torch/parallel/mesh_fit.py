"""Mesh-sharded fit and compress: the data-parallel trainer, a species/row
sharded guarantee engine, and the sharded landing buffer of streaming
ingest.

Counterpart of the JAX package's ``parallel/mesh_fit.py``. The paper's
production fields (full species sets, hundreds of timesteps) exceed one
accelerator's memory, so the fit/compress path gains a data axis in three
places. One host thread drives every shard over a
:class:`~repro_torch.parallel.Mesh`, as the reference's single controller
does.

* **Data-parallel trainer** — :func:`dp_fit`, behind
  ``MiniBatchTrainer.fit(mesh=...)``: rows are split into ``P`` equal
  contiguous shards, shard ``i`` on ``mesh.devices[i]``; every shard takes
  its loss and gradients on its own device (every shard's launches are
  queued before any exchange), the gradients are exchanged as ``psum / P``
  — an fp32 sum in shard order on every device, or the int8 exchange of
  :func:`~repro_torch.parallel.gradient_compression.quantized_psum` — and
  the same AdamW update runs on every replica, so the replicas stay
  **bitwise equal** (checked at the end of every fit). On a 1-device mesh
  the trainer runs its plain single-device loop, so params and losses are
  bitwise the plain fit's.
* **Sharded guarantee engine** — :class:`ShardedGuaranteeEngine` keeps the
  prepared tensors on the host (pinned where a device is CUDA) and runs
  each batched kernel program over contiguous species (and block-row)
  chunks, one chunk per shard, placed round-robin on the devices. The
  kernels are per-species and per-block-row pure, so the reassembled
  results, the artifacts and the container are **byte-identical** to the
  single-device engine's, and no device holds the full (S, NB, D)
  problem.
* **Streaming sharded ingest** — :class:`ShardedBlockStore` is the
  landing buffer of the mesh ``fit_stream``: each normalised chunk's
  blocks are written straight into row shards on the devices, so the host
  holds one chunk at a time and each device ``NB / P`` block rows.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import gae
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.parallel import Mesh, as_tensor
from repro_torch.parallel import gradient_compression as gc
from repro_torch.train import optimizer as opt


# ---------------------------------------------------------------------------
# (1) data-parallel trainer
# ---------------------------------------------------------------------------
#: values per scale of the int8 gradient exchange (the reference's default)
BLOCK = gc.CompressionConfig().block


def shard_generator(seed: int, shard: int, device) -> torch.Generator:
    """Generator of shard ``shard``'s batch-index stream (``P > 1``): seeded
    from ``(seed, salt, shard)``, the counterpart of the reference's
    ``fold_in(batch_key(seed), axis_index)``."""
    from repro_torch.train.train_loop import _BATCH_SALT

    state = np.random.SeedSequence([int(seed), _BATCH_SALT, int(shard)])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return g


def pack_bucket(grads: dict, block: int) -> torch.Tensor:
    """Every leaf flattened to fp32 and zero-padded to a multiple of
    ``block``, concatenated in dict order: one exchange (one quantiser
    launch) a shard a step. The bucket's blocks are exactly the per-leaf
    blocks, so quantising the bucket gives the bits of quantising leaf by
    leaf."""
    return torch.cat([gc._blocks(g, block).reshape(-1) for g in grads.values()])


def unpack_bucket(bucket: torch.Tensor, like: dict, block: int) -> dict:
    out, off = {}, 0
    for k, p in like.items():
        n = p.numel()
        out[k] = bucket[off:off + n].reshape(p.shape).to(p.dtype)
        off += n + (-n) % block
    return out


def psum(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """fp32 sum of per-shard tensors in shard order, on every shard's
    device (out of place: a repeated device must not alias a shard)."""
    out = []
    for s in shards:
        total = shards[0].to(s.device)
        for x in shards[1:]:
            total = total + x.to(s.device)
        out.append(total)
    return out


#: cross-replica gradient exchanges since the last reset, by kind (the
#: trace audit's count of a data-parallel step's collectives)
EXCHANGES: dict[str, int] = {"psum": 0, "quantized_psum": 0}


def dp_step(trainer, replicas: list, states: list, batches: Sequence[tuple], *,
            quantized: bool):
    """One data-parallel step over ``P = len(replicas)`` replicas: every
    shard's loss and gradients on its own device (all queued before the
    exchange), one exchange of the packed gradients (``psum``, or the int8
    ``quantized_psum`` with ``quantized``), divided by ``P``, and the same
    in-place AdamW update on every replica. Returns ``(replicas, states,
    loss)``, the loss the mean of the shards' in shard order on the first
    device."""
    n_p = len(replicas)
    shard_losses, buckets = [], []
    for replica, batch in zip(replicas, batches, strict=True):
        loss, grads = trainer.loss_and_grads(replica, batch)
        shard_losses.append(loss)
        buckets.append(pack_bucket(grads, BLOCK))
    kind = "quantized_psum" if quantized else "psum"
    summed = (gc.quantized_psum(buckets, block=BLOCK) if quantized
              else psum(buckets))
    EXCHANGES[kind] += 1
    loss = shard_losses[0]
    for x in shard_losses[1:]:
        loss = loss + x.to(loss.device)
    with torch.no_grad():
        for i in range(n_p):
            grads = unpack_bucket(summed[i] / n_p, replicas[i], BLOCK)
            opt.update_(trainer._ocfg, grads, states[i], replicas[i])
    return replicas, states, loss / n_p


def dp_fit(trainer, params: dict, shards: Sequence[tuple], *, steps: int,
           n: int, bs: int, seed: int, log_every: int, mesh: Mesh,
           quantized: bool, indices=None):
    """The trainer's data-parallel run; returns ``(replicas, losses)``.

    ``shards[i]`` is shard ``i``'s tuple of data arrays (equal row counts,
    on ``mesh.devices[i]``). ``n`` and ``bs`` are the global row and batch
    counts and must divide the mesh size (the trainer trims). Shard ``i``
    draws its local batch of ``bs / P`` rows from its own ``n / P`` rows
    with :func:`shard_generator`, or takes row ``t`` of ``indices[i]`` (a
    ``(P, steps, bs / P)`` matrix) at step ``t``. The gradients are
    exchanged as ``psum / P`` (int8-quantised with ``quantized``, in blocks
    of ``BLOCK``) and the logged loss is the mean of the shards' losses in
    shard order.
    """
    n_p = mesh.size
    if n % n_p or bs % n_p:
        raise ValueError(
            f"global rows {n} and batch {bs} must divide the mesh size {n_p}")
    n_local, bs_local = n // n_p, bs // n_p
    devs = mesh.devices
    # clones: on a repeated device, .to() would hand every replica the
    # caller's tensors
    replicas = [{k: p.detach().to(d, copy=True) for k, p in params.items()}
                for d in devs]
    states = [opt.init_state(r) for r in replicas]
    if indices is not None:
        indices = np.asarray(indices)
        if indices.shape != (n_p, steps, bs_local):
            raise ValueError(f"indices has shape {indices.shape}, expected "
                             f"{(n_p, steps, bs_local)}")
        indices = [torch.tensor(indices[i], dtype=torch.int64, device=d)
                   for i, d in enumerate(devs)]
    else:
        gens = [shard_generator(seed, i, d) for i, d in enumerate(devs)]
    losses = []
    with strict_fp32():
        for t in range(steps):
            batches = []
            for i, d in enumerate(devs):
                idx = (indices[i][t] if indices is not None else
                       torch.randint(0, n_local, (bs_local,), generator=gens[i],
                                     device=d))
                batches.append(tuple(a[idx] for a in shards[i]))
            _, _, loss = dp_step(trainer, replicas, states, batches,
                                 quantized=quantized)
            losses.append(loss)
            if log_every and t % log_every == 0:
                trainer._log_fn(t, float(losses[-1]))
    for i, r in enumerate(replicas[1:], 1):
        if not all(torch.equal(r[k].to(devs[0]), replicas[0][k]) for k in r):
            raise RuntimeError(f"replica {i} differs from replica 0 after the "
                               "data-parallel fit")
    hist = (torch.stack(losses).float().cpu().numpy() if losses
            else np.zeros(0, np.float32))
    return replicas, hist


def dp_wire_report(params: dict, n_devices: int, *, n_bits: int = 8,
                   block: int = 64) -> dict:
    """Per-step gradient-exchange wire bytes, from the leaf shapes.

    The quantised exchange sends each device every other device's int
    payload plus one fp32 scale a ``block`` of values, ``(P - 1) * (q +
    s)`` bytes a device a step; the fp32 yardstick is a ring all-reduce at
    ``2 * (P - 1) / P * 4n`` bytes a device."""
    q_bytes = scale_bytes = f32_bytes = 0
    for leaf in params.values():
        size = int(np.prod(tuple(leaf.shape))) if tuple(leaf.shape) else 1
        blocks = -(-size // block)
        q_bytes += blocks * block * n_bits // 8
        scale_bytes += blocks * 4
        f32_bytes += size * 4
    p = max(int(n_devices), 1)
    quant = (q_bytes + scale_bytes) * (p - 1)
    fp32 = 2 * f32_bytes * (p - 1) // p
    return {
        "n_devices": p,
        "n_bits": n_bits,
        "block": block,
        "grad_fp32_bytes": f32_bytes,
        "quantized_bytes_per_step": quant,
        "fp32_bytes_per_step": fp32,
        "wire_ratio": (fp32 / quant) if quant else float("inf"),
    }


# ---------------------------------------------------------------------------
# (2) species/block-row sharded guarantee engine
# ---------------------------------------------------------------------------
#: how each positional argument of an engine program is chunked, from the
#: port's call sites in core/gae.py: "SR" splits species and block rows
#: (S, NB, ...), "S" species only (S, D, D), None is passed whole (scalars).
#: Every output is (S, NB, ...) and reassembles as "SR".
_KERNEL_PLANS = {
    # prepare: residual (S, NB, D) f64, basis (S, D, D) f64
    "project": ("SR", "S"),
    # select, device backend: coeffs, coeffs_sorted, inv_rank, norms2 (S,
    # NB), x_rec, basis32, tau2, bin_size -> corrected, cq, m_eff, achieved
    "select": ("SR", "SR", "SR", "SR", "SR", "S", None, None),
    # select, host backend: x_rec, cqv32, inv_rank, m_eff (S, NB), basis32
    "correct": ("SR", "SR", "SR", "SR", "S"),
    # replay: x_rec, dense, basis_pad
    "apply": ("SR", "SR", "S"),
}


def _split_points(total: int, parts: int) -> list[int]:
    """Balanced contiguous split boundaries (deterministic)."""
    return [(total * i) // parts for i in range(parts + 1)]


def _chunk_plan(s: int, nb: int, n_shards: int) -> list[tuple]:
    """(s0, s1, r0, r1) extents: species-major, rows split only when shards
    outnumber species (then each chunk holds one species, so every chunk
    is a contiguous slice of the (S, NB, ...) layout)."""
    n_s = max(1, min(s, n_shards))
    n_r = max(1, min(n_shards // n_s, nb))
    sb = _split_points(s, n_s)
    rb = _split_points(nb, n_r)
    return [
        (sb[i], sb[i + 1], rb[j], rb[j + 1])
        for i in range(n_s)
        for j in range(n_r)
        if sb[i + 1] > sb[i] and rb[j + 1] > rb[j]
    ]


class ShardedGuaranteeEngine(gae.GuaranteeEngine):
    """GuaranteeEngine whose batched programs run one chunk a shard over
    species (and block rows), placed round-robin on the mesh devices.

    Prepared tensors stay on the host (the ``_stage`` seam; pinned when a
    device is CUDA). ``_dispatch`` uploads each chunk to its device with
    ``non_blocking`` copies, runs the program there, and queues the copy of
    its results into a pinned host tensor, for every chunk before it waits
    for any; the chunks of one device alternate between two streams, so
    one chunk's copies overlap the other's kernels. Results come back as
    host tensors, concatenated in the batched layout.

    The kernels are per-species and per-block-row pure (the projection is
    a per-species product, selection cumsums and cuts run within a block
    row, the correction is a per-row masked product), so the artifacts,
    and the serialized container, are byte-identical to the default
    engine's.

    ``n_shards`` is the chunk count, separate from the device count
    (default: the device count), so the chunked path also runs on one
    device. The devices are ``mesh``'s, or without a mesh the engine's
    ``device``.
    """

    def __init__(self, mesh: Optional[Mesh] = None,
                 n_shards: Optional[int] = None, **kw):
        self._devices = list(mesh.devices if mesh is not None
                             else (resolve_device(kw.get("device")),))
        self._n_shards = int(n_shards) if n_shards else len(self._devices)
        if self._n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self._n_shards}")
        kw.setdefault("device", self._devices[0])
        super().__init__(**kw)
        self._pin = any(d.type == "cuda" for d in self._devices)
        self._streams: dict = {}

    def _stage(self, arr):
        t = arr.cpu() if isinstance(arr, torch.Tensor) else as_tensor(arr)
        return t.pin_memory() if self._pin else t

    def _stream(self, dev: torch.device, i: int):
        if dev.type != "cuda":
            return None
        pair = self._streams.get(str(dev))
        if pair is None:
            pair = self._streams[str(dev)] = [torch.cuda.Stream(dev)
                                              for _ in range(2)]
        return pair[i % 2]

    def _dispatch(self, kernel: str, *args):
        plan = _KERNEL_PLANS[kernel]
        lead = next(a for a, ax in zip(args, plan) if ax == "SR")
        s, nb = int(lead.shape[0]), int(lead.shape[1])
        chunks = _chunk_plan(s, nb, self._n_shards)
        fn = getattr(self, f"_{kernel}")
        outs, per_device = None, {}
        for i, (s0, s1, r0, r1) in enumerate(chunks):
            dev = self._devices[i % len(self._devices)]
            # a device's chunks alternate between its two streams (a
            # repeated device counts as one)
            nth = per_device[str(dev)] = per_device.get(str(dev), -1) + 1
            stream = self._stream(dev, nth)
            if stream is not None:
                # a device tensor among the args was written on the
                # caller's stream
                stream.wait_stream(torch.cuda.current_stream(dev))
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                call = [
                    a if ax is None else
                    (a[s0:s1] if ax == "S" else a[s0:s1, r0:r1])
                    .contiguous().to(dev, non_blocking=True)
                    for a, ax in zip(args, plan)
                ]
                res = fn(*call)
                res = res if isinstance(res, tuple) else (res,)
                if outs is None:
                    outs = [torch.empty((s, nb) + tuple(r.shape[2:]),
                                        dtype=r.dtype, pin_memory=self._pin)
                            for r in res]
                for o, r in zip(outs, res):
                    o[s0:s1, r0:r1].copy_(r, non_blocking=True)
                del call, res
        for dev in {str(d): d for d in self._devices}.values():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return outs[0] if len(outs) == 1 else tuple(outs)


# ---------------------------------------------------------------------------
# (3) streaming sharded ingest buffer (mesh fit_stream)
# ---------------------------------------------------------------------------
class ShardedBlockStore:
    """Row-sharded landing buffer for two-pass streaming ingest: one tensor
    of ``NB / P`` rows on each mesh device.

    ``append`` writes a chunk's rows at the cursor, split where the chunk
    straddles a shard boundary; the copies are synchronous, so the host
    holds one chunk at a time. ``NB`` must divide the mesh size, so every
    device owns an equal contiguous row range (raised at construction, not
    mid-ingest).
    """

    def __init__(self, nb: int, tail_shape: tuple, mesh: Mesh):
        n_p = mesh.size
        if nb % n_p:
            raise ValueError(
                f"streamed block count {nb} does not divide the mesh size "
                f"{n_p}; choose a chunking/geometry with NB % P == 0")
        self.nb = int(nb)
        self.mesh = mesh
        self._per = self.nb // n_p
        self._rows = 0
        self._bufs = [torch.zeros((self._per, *tail_shape), device=d)
                      for d in mesh.devices]

    def append(self, part) -> None:
        part = as_tensor(part)
        n = int(part.shape[0])
        if self._rows + n > self.nb:
            raise ValueError(f"append overflows the store: {self._rows} + "
                             f"{n} > {self.nb} rows")
        r = 0
        while r < n:
            shard, off = divmod(self._rows + r, self._per)
            take = min(n - r, self._per - off)
            self._bufs[shard][off:off + take].copy_(part[r:r + take])
            r += take
        self._rows += n

    def finish(self) -> list[torch.Tensor]:
        """The filled row shards; raises if rows are missing."""
        if self._rows != self.nb:
            raise ValueError(f"store holds {self._rows} of {self.nb} block rows")
        return list(self._bufs)

    def per_device_bytes(self) -> dict[str, int]:
        """Resident bytes per device — the ingest memory high-water."""
        out: dict[str, int] = {}
        for buf in self._bufs:
            key = str(buf.device)
            out[key] = out.get(key, 0) + buf.numel() * buf.element_size()
        return out
