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


# strict_fp32's process-wide state: how many callers are inside it (any
# thread), and the flags the first of them found on entry
_STRICT_LOCK = threading.Lock()
_strict_depth = 0
_strict_saved: Optional[tuple] = None


def _fp32_flags() -> tuple:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
            cudnn.deterministic)


def _set_fp32_flags(flags: tuple) -> None:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
     cudnn.deterministic) = flags


@contextlib.contextmanager
def strict_fp32():
    """True-fp32 numerics for the enclosed calls (see module docstring).

    The four backend flags (cuDNN and matmul TF32, cuDNN autotuning and
    determinism) are process-wide, so entries are counted across threads
    under one lock: the first caller to enter saves the flags and sets
    the strict values, later entries (nested, or from other threads) only
    count, and the last caller to leave restores what the first one
    found. A thread inside never sees another thread's exit undo its
    flags. While any thread is inside, every thread of the process sees
    the strict flags, including one that never entered."""
    global _strict_depth, _strict_saved
    with _STRICT_LOCK:
        if _strict_depth == 0:
            _strict_saved = _fp32_flags()
            _set_fp32_flags((False, False, False, True))
        _strict_depth += 1
    try:
        yield
    finally:
        with _STRICT_LOCK:
            _strict_depth -= 1
            if _strict_depth == 0:
                _set_fp32_flags(_strict_saved)
                _strict_saved = None
