"""Fault tolerance: step watchdog / straggler detection + checkpoint-restart.

A copy of the reference's ``train/fault_tolerance.py`` (host Python and
numpy only), kept in the port so that the port imports nothing of the
reference. Two failure modes matter at scale: (a) hard node loss, handled
by checkpoint/restart, and (b) stragglers, handled by per-step timing
against a robust running median.

``run_with_recovery`` is the single-controller loop of a training job:
it executes steps, checkpoints every N through the ``ckpt`` manager it is
given, and on a :class:`StepFailure` restores the latest checkpoint and
replays; exactly-once semantics need a step-indexed data pipeline, so a
replayed step consumes identical batches. :func:`retry_with_backoff` is
the same idiom for one restartable unit; ``GBATCPipeline.fit_stream``
retries its two ingest passes with it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np


class StepFailure(RuntimeError):
    """Raised by injected failures in tests; a deployment raises it for a
    step that failed on the device."""


def retry_with_backoff(
    fn: Callable[[], Any],
    *,
    max_retries: int = 3,
    backoff: float = 0.1,
    retry_on: tuple = (OSError, IOError, StepFailure),
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> Any:
    """Run ``fn()``; on a retryable exception restart it, up to
    ``max_retries`` times, sleeping ``backoff * 2**attempt`` between
    tries.

    The checkpoint-restart idiom of :func:`run_with_recovery` scaled
    down to a single restartable unit: ``fn`` must be a pure restart —
    re-running it from the top must be equivalent to a clean first run
    (the streaming-fit passes qualify: each is a pure function of a
    re-iterable loader). Exceptions outside ``retry_on`` (shape errors,
    validation) propagate immediately — only transient faults retry.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if attempt >= max_retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff > 0:
                sleep(backoff * (2 ** attempt))
            attempt += 1


@dataclasses.dataclass
class Watchdog:
    """Flags steps slower than `threshold` x running median."""

    threshold: float = 3.0
    window: int = 32

    def __post_init__(self):
        self._times: list[float] = []
        self.straggler_steps: list[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self._times) >= 5:
            med = float(np.median(self._times[-self.window:]))
            is_straggler = seconds > self.threshold * med
        if is_straggler:
            self.straggler_steps.append(step)
        self._times.append(seconds)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0

    @property
    def times(self) -> list[float]:
        """Every observed step's seconds, in order."""
        return list(self._times)


def run_with_recovery(
    *,
    step_fn: Callable[[int, Any], Any],  # (step, state) -> state
    init_state: Any,
    n_steps: int,
    ckpt,  # CheckpointManager
    save_every: int = 10,
    max_restarts: int = 3,
    watchdog: Optional[Watchdog] = None,
    on_straggler: Optional[Callable[[int], None]] = None,
    state_to_tree: Callable[[Any], Any] = lambda s: s,
    tree_to_state: Callable[[Any, Any], Any] = lambda tmpl, t: t,
) -> tuple[Any, dict]:
    """Run n_steps with checkpoint-restart. Returns (state, report)."""
    state = init_state
    step = 0
    restarts = 0
    # resume if a checkpoint exists
    latest = ckpt.latest_step()
    if latest is not None:
        tree, got = ckpt.restore(state_to_tree(init_state))
        state = tree_to_state(init_state, tree)
        step = got + 1

    while step < n_steps:
        try:
            t0 = time.perf_counter()
            state = step_fn(step, state)
            dt = time.perf_counter() - t0
            if watchdog is not None and watchdog.observe(step, dt):
                if on_straggler is not None:
                    on_straggler(step)
            if step % save_every == 0:
                ckpt.save(step, state_to_tree(state))
            step += 1
        except StepFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            latest = ckpt.latest_step()
            if latest is None:
                state = init_state
                step = 0
                continue
            tree, got = ckpt.restore(state_to_tree(init_state))
            state = tree_to_state(init_state, tree)
            step = got + 1
    ckpt.wait()
    return state, {
        "restarts": restarts,
        "stragglers": list(watchdog.straggler_steps) if watchdog else [],
        "final_step": step,
    }
