"""Named wall-clock spans for the ``timings`` dicts of the codec's stages.

The codec itself never reads a clock: a timestamp that reached a cache key
or a wire byte would make identical inputs give different artifacts. The
stage timings the pipeline and the guarantee engine report
(``GBATCPipeline.timings``, ``GuaranteeEngine.last_prepare_s``) are the one
use of time here, and they all go through :class:`Stopwatch`, whose
:meth:`Stopwatch._read` is the only clock call under ``core/``.

Usage::

    sw = Stopwatch()
    with sw("select"):
        ...
    timings.update(sw.spans)  # {"select": seconds}

A key timed twice holds the sum of its spans.
"""

from __future__ import annotations

import contextlib
import time


class Stopwatch:
    """Seconds spent in named ``with`` blocks, in ``spans`` (first-exit order)."""

    def __init__(self):
        self.spans: dict[str, float] = {}

    @staticmethod
    def _read() -> float:
        # the spans reach timings dicts only, never a cache key or a wire byte
        return time.perf_counter()  # repro: allow[determinism]

    @contextlib.contextmanager
    def __call__(self, key: str):
        t0 = self._read()
        try:
            yield
        finally:
            self.spans[key] = self.spans.get(key, 0.0) + (self._read() - t0)
