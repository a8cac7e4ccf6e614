"""Device and numerics rules shared by every entry point of the port.

* ``device=None`` means the GPU. Without CUDA that raises; nothing carries
  on silently on the CPU. Tests pass ``device="cpu"`` explicitly.
* The reference is true fp32 (fp64 in the guarantee projection), so the
  port's own calls run with TF32 off for matmuls *and* for cuDNN
  convolutions (cuDNN's TF32 is on by default and would move the
  reconstruction by ~1e-3 relative), and with cuDNN autotuning off so the
  same shape always picks the same algorithm on the encode and decode
  sides.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises without CUDA); anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' explicitly to run the plain "
                "PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _ScopedFlags:
    """Process-wide flags held at one value while any caller is inside a
    scope. Entries are counted across threads under one lock: the first
    caller to enter saves the flags and sets the scope's values, later
    entries (nested, or from other threads) only count, and the last
    caller to leave restores what the first one found. A thread inside
    never sees another thread's exit undo its flags. While any thread is
    inside, every thread of the process sees the scope's values, including
    one that never entered."""

    def __init__(self, get, set_, values: tuple):
        self._get, self._set, self._values = get, set_, values
        self._lock = threading.Lock()
        self._depth = 0
        self._saved: Optional[tuple] = None

    @contextlib.contextmanager
    def scope(self):
        with self._lock:
            if self._depth == 0:
                self._saved = self._get()
                self._set(self._values)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    self._set(self._saved)
                    self._saved = None


def _fp32_flags() -> tuple:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
            cudnn.deterministic)


def _set_fp32_flags(flags: tuple) -> None:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
     cudnn.deterministic) = flags


_STRICT = _ScopedFlags(_fp32_flags, _set_fp32_flags, (False, False, False, True))
_DETERMINISTIC = _ScopedFlags(
    lambda: (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled()),
    lambda flags: torch.use_deterministic_algorithms(flags[0], warn_only=flags[1]),
    (True, True))


def strict_fp32():
    """True-fp32 numerics for the enclosed calls (see module docstring):
    cuDNN and matmul TF32 off, cuDNN autotuning off and determinism on.
    The four backend flags are process-wide, so entries are counted
    across threads (:class:`_ScopedFlags`)."""
    return _STRICT.scope()


def deterministic():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for the
    enclosed calls: the scatter-adds of the embedding's and the gathers'
    backward take their deterministic kernels on CUDA, so a replayed
    training step gives the same bits. Scoped as :func:`strict_fp32`
    (the flags are process-wide). ``warn_only``: an operation without a
    deterministic kernel warns instead of raising, and the caller's
    bitwise check is the proof."""
    return _DETERMINISTIC.scope()
