"""Decode service: continuous-batched selective decode over GBATC blobs.

The paper's consumers are analysts issuing many small queries (one
species, one time window) against hot compressed fields. The per-request
machinery (:class:`repro_torch.codec.PartialDecoder`) makes each query
cheap; this module makes the *aggregate workload* fast: a
single-controller scheduler thread drains in-flight requests from a queue
and coalesces the ones that can share work into one fused decode,
scattering per-request slices back out, each bitwise equal to the serial
``PartialDecoder`` answer.

Continuous batching, concretely (one scheduler *tick*):

1. drain up to ``max_batch`` queued requests (the queue refills while a
   tick runs, so under concurrent load batches form naturally: no
   explicit batching window, no wall-clock);
2. handle salvage-mode and unknown-blob requests individually (salvage
   decodes through its own quarantining path and must never share state
   with clean decodes);
3. group the rest by **blob**: requests on one blob share a parsed head
   and hence a decode runtime. Requests on *different* blobs are never
   fused even when their runtime structure matches: their decoder
   parameters differ;
4. per group: plan every request (:func:`repro_torch.codec.partial.plan_slice`;
   a malformed request fails alone), dedup identical plans (duplicates
   share one computation), merge overlapping/adjacent block-row windows,
   and run ONE fused NN decode per merged row interval. The interval runs
   in the full decode's launch geometry
   (:func:`~repro_torch.codec.runtime._fused_vecs` with ``rows=(B0, nb)``),
   so each of its rows is bitwise the full decode's row whatever window
   it was merged into;
5. per (b0, b1) window subgroup: entropy-decode + correction-replay the
   **species union** once, in one launch of the correction kernel (each
   species' corrected rows are independent of its batch-mates), then hand
   each request its species positions and finalize its exact slice.

Every launch runs on the scheduler thread's current CUDA stream. The
fused decode launches without waiting, and the replay stage
entropy-decodes the union's guarantee streams on the host before anything
waits on the device, so host and device work already overlap on one
stream; a side stream would add cross-stream lifetime hazards for the
cached head's device tensors and buy no further overlap. Results stay on
the device until ``finalize_slice`` copies each request's slice to the
host.

Error isolation: a request that hits a
:class:`~repro_torch.core.container.ContainerFormatError` mid-batch gets
the structured error on its own future; batch-mates fall back to
per-request processing and still succeed (matching serial semantics,
including the corrupt blob's head eviction). All decode state the service
shares across threads lives in the multi-tier decode cache
(:mod:`repro_torch.codec.cache`); ``repro_torch.codec.cache_stats()``
observes it.

Usage::

    with DecodeService() as svc:          # device=None: the GPU
        svc.register("run42", blob)
        fut = svc.submit("run42", species=3, time_range=(4, 12))
        field = fut.result()          # == PartialDecoder(blob).decode(...)
        field2 = svc.decode("run42", species=[1, 3])   # blocking helper
        print(svc.stats.as_dict(), codec.cache_stats())

Everything the service serves derives from registered blob bytes alone:
no environment reads, no pipeline-config imports.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import Any, Optional

import torch

from repro_torch.codec.partial import (
    SlicePlan,
    finalize_slice,
    plan_slice,
    replay_slice,
)
from repro_torch.codec.runtime import (
    _cached_head,
    _evict_head,
    _fused_vecs,
    _latents32,
)
from repro_torch.core.container import ContainerFormatError
from repro_torch.device import DeviceLike, resolve_device

_STOP = object()  # queue sentinel: drains behind in-flight requests


@dataclasses.dataclass
class ServeStats:
    """Scheduler-side counters (mutated only by the scheduler thread).

    ``coalesced`` counts requests that shared a fused dispatch with at
    least one other request; ``deduped`` counts requests answered from a
    batch-mate's identical computation without any work of their own.
    ``dispatches`` is the number of fused NN decodes actually launched:
    the batching win is ``requests`` growing faster than ``dispatches``.
    """

    requests: int = 0
    completed: int = 0
    errors: int = 0
    salvaged: int = 0
    ticks: int = 0
    dispatches: int = 0
    coalesced: int = 0
    deduped: int = 0
    fallbacks: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Pending:
    """One queued request: its identity plus the future to resolve."""

    blob_id: str
    species: Any
    time_range: Any
    on_error: str
    future: Future


def _merge_intervals(spans: "list[tuple[int, int]]") \
        -> "list[tuple[int, int]]":
    """Merge overlapping/adjacent half-open [b0, b1) row intervals."""
    merged: "list[list[int]]" = []
    for b0, b1 in sorted(spans):
        if merged and b0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b1)
        else:
            merged.append([b0, b1])
    return [(b0, b1) for b0, b1 in merged]


class DecodeService:
    """Continuous-batched selective-decode server over registered blobs.

    ``submit`` enqueues a request and returns a
    :class:`concurrent.futures.Future`; the scheduler thread resolves it
    with the decoded slice (or the structured error the serial path
    would raise). ``decode`` is the blocking convenience wrapper. The
    service is a context manager: entering starts the scheduler, exiting
    stops it after draining in-flight requests.

    ``device=None`` decodes on the GPU and raises without CUDA;
    ``device="cpu"`` runs the kernels' plain versions on the CPU.
    """

    def __init__(self, *, max_batch: int = 32, device: DeviceLike = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.device = resolve_device(device)
        self.stats = ServeStats()
        self._blobs: "dict[str, bytes]" = {}
        self._blobs_lock = threading.Lock()
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._lifecycle = threading.Lock()
        self._stopped = False

    # -- blob registry ----------------------------------------------------
    def register(self, blob_id: str, blob: bytes) -> str:
        """Register container bytes under ``blob_id`` (parsed lazily, on
        first request, through the shared head cache)."""
        with self._blobs_lock:
            self._blobs[blob_id] = bytes(blob)
        return blob_id

    def unregister(self, blob_id: str) -> None:
        with self._blobs_lock:
            self._blobs.pop(blob_id, None)

    def blob_ids(self) -> "list[str]":
        with self._blobs_lock:
            return sorted(self._blobs)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "DecodeService":
        with self._lifecycle:
            if self._stopped:
                raise RuntimeError("DecodeService already stopped")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="decode-service", daemon=True
                )
                self._thread.start()
        return self

    def stop(self) -> None:
        """Stop after draining everything already submitted."""
        with self._lifecycle:
            if self._stopped:
                return
            self._stopped = True
            thread = self._thread
        self._queue.put(_STOP)
        if thread is not None:
            thread.join()

    def __enter__(self) -> "DecodeService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request entry points ---------------------------------------------
    def submit(self, blob_id: str, species=None, time_range=None,
               on_error: str = "raise") -> Future:
        """Enqueue one selective-decode request; resolves to exactly what
        ``PartialDecoder(blob, device).decode(species, time_range,
        on_error)`` returns (or raises)."""
        if on_error not in ("raise", "salvage"):
            raise ValueError(
                f"on_error must be 'raise' or 'salvage', got {on_error!r}"
            )
        with self._lifecycle:
            if self._stopped:
                raise RuntimeError("DecodeService already stopped")
            if self._thread is None:
                raise RuntimeError(
                    "DecodeService not started (use start() or a with-block)"
                )
        fut: Future = Future()
        self._queue.put(_Pending(blob_id, species, time_range,
                                 on_error, fut))
        return fut

    def decode(self, blob_id: str, species=None, time_range=None,
               on_error: str = "raise"):
        """Blocking ``submit(...).result()``."""
        return self.submit(blob_id, species, time_range, on_error).result()

    # -- scheduler --------------------------------------------------------
    def _run(self) -> None:
        while True:
            first = self._queue.get()
            if first is _STOP:
                return
            batch = [first]
            stop = False
            while len(batch) < self.max_batch:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is _STOP:
                    # drained mid-batch: process the batch, then exit
                    stop = True
                    break
                batch.append(item)
            self._tick(batch)
            if stop:
                return

    def _tick(self, batch: "list[_Pending]") -> None:
        self.stats.ticks += 1
        self.stats.requests += len(batch)
        groups: "dict[str, list[_Pending]]" = {}
        for req in batch:
            with self._blobs_lock:
                blob = self._blobs.get(req.blob_id)
            if blob is None:
                self._fail(req, KeyError(
                    f"unknown blob_id {req.blob_id!r} (register it first)"
                ))
            elif req.on_error == "salvage":
                self._serve_salvage(req, blob)
            else:
                groups.setdefault(req.blob_id, []).append(req)
        for blob_id, reqs in groups.items():
            with self._blobs_lock:
                blob = self._blobs[blob_id]
            self._serve_group(blob, reqs)

    # -- per-request paths ------------------------------------------------
    def _fail(self, req: _Pending, exc: BaseException) -> None:
        self.stats.errors += 1
        req.future.set_exception(exc)

    def _finish(self, req: _Pending, result) -> None:
        self.stats.completed += 1
        req.future.set_result(result)

    def _serve_salvage(self, req: _Pending, blob: bytes) -> None:
        """Salvage decodes run isolated: the quarantining path parses its
        own head and never reads or writes the shared clean-decode cache,
        so a corrupt blob cannot poison batch-mates through it."""
        from repro_torch.codec.integrity import salvage_decompress

        try:
            result = salvage_decompress(
                blob, species=req.species, time_range=req.time_range,
                device=self.device,
            )
        except (ContainerFormatError, ValueError) as e:
            self._fail(req, e)
            return
        self.stats.salvaged += 1
        self._finish(req, result)

    def _serve_serial(self, head, blob: bytes, req: _Pending,
                      plan: Optional[SlicePlan] = None) -> None:
        """Per-request fallback: the serial PartialDecoder path, used when
        a batched stage raised so healthy batch-mates get individually
        retried and the corrupt request fails alone."""
        self.stats.fallbacks += 1
        try:
            if plan is None:
                plan = plan_slice(head, req.species, req.time_range)
            lat32 = _latents32(
                head.latents.rows(plan.b0, plan.b1), head.latent_bin
            )
            vecs = _fused_vecs(
                head.runtime, head.dec_state, head.corr_state, lat32,
                rows=(plan.b0, head.nb),
            )
            vecs_sel = vecs[torch.as_tensor(plan.idx, device=vecs.device)]
            vecs_sel = replay_slice(
                head, plan.idx, (plan.b0, plan.b1), vecs_sel
            )
            self._finish(req, finalize_slice(head, plan, vecs_sel))
        except ContainerFormatError as e:
            _evict_head(blob, self.device)  # serial decode() semantics
            self._fail(req, e)
        except ValueError as e:
            self._fail(req, e)

    # -- the batched path -------------------------------------------------
    def _serve_group(self, blob: bytes, reqs: "list[_Pending]") -> None:
        """Serve one blob's requests from shared fused dispatches."""
        try:
            head = _cached_head(blob, self.device)
        except ContainerFormatError as e:
            # the head itself is bad: every request on this blob raises,
            # exactly as each serial decode would
            for req in reqs:
                self._fail(req, e)
            return
        plans: "dict[tuple, SlicePlan]" = {}
        takers: "dict[tuple, list[_Pending]]" = {}
        for req in reqs:
            try:
                plan = plan_slice(head, req.species, req.time_range)
            except ValueError as e:
                self._fail(req, e)  # malformed request fails alone
                continue
            if plan.key in plans:
                self.stats.deduped += 1
            plans[plan.key] = plan
            takers.setdefault(plan.key, []).append(req)
        if not plans:
            return
        distinct = list(plans.values())
        for B0, B1 in _merge_intervals(
            [(p.b0, p.b1) for p in distinct]
        ):
            members = [p for p in distinct if p.b0 >= B0 and p.b1 <= B1]
            try:
                lat32 = _latents32(
                    head.latents.rows(B0, B1), head.latent_bin
                )
                vecs_dev = _fused_vecs(
                    head.runtime, head.dec_state, head.corr_state, lat32,
                    rows=(B0, head.nb),
                )
            except ContainerFormatError:
                # a latent shard in the union is corrupt: per-request
                # retries touch only each request's own rows, so only
                # requests whose window covers the bad shard raise
                for plan in members:
                    for req in takers[plan.key]:
                        self._serve_serial(head, blob, req, plan)
                continue
            self.stats.dispatches += 1
            self._scatter(head, blob, vecs_dev, (B0, B1), members, takers)

    def _scatter(self, head, blob: bytes, vecs_dev, span, members, takers):
        """Replay the species union once per (b0, b1) window subgroup,
        then finalize each plan from its positions of the union."""
        B0, _ = span
        dev = vecs_dev.device
        windows: "dict[tuple[int, int], list[SlicePlan]]" = {}
        for plan in members:
            windows.setdefault((plan.b0, plan.b1), []).append(plan)
        for (b0, b1), window_plans in windows.items():
            n_riders = sum(len(takers[p.key]) for p in window_plans)
            if n_riders > 1:
                self.stats.coalesced += n_riders
            union = sorted({s for p in window_plans for s in p.idx})
            pos = {s: i for i, s in enumerate(union)}
            vecs_u = vecs_dev[torch.as_tensor(union, device=dev)][
                :, b0 - B0 : b1 - B0].contiguous()
            try:
                vecs_u = replay_slice(head, union, (b0, b1), vecs_u)
            except ContainerFormatError:
                # one species' guarantee stream is corrupt: retries
                # decode each request's own species so healthy requests
                # coalesced with the corrupt one still succeed
                for plan in window_plans:
                    for req in takers[plan.key]:
                        self._serve_serial(head, blob, req, plan)
                continue
            for plan in window_plans:
                sel = torch.as_tensor([pos[s] for s in plan.idx], device=dev)
                try:
                    out = finalize_slice(head, plan, vecs_u[sel])
                except ContainerFormatError as e:
                    _evict_head(blob, self.device)
                    for req in takers[plan.key]:
                        self._fail(req, e)
                    continue
                for req in takers[plan.key]:
                    self._finish(req, out)
