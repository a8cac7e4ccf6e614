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


@contextlib.contextmanager
def strict_fp32():
    """True-fp32 numerics for the enclosed calls (see module docstring);
    restores the previous backend flags on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
             cudnn.deterministic)
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    cudnn.benchmark = False
    cudnn.deterministic = True
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
         cudnn.deterministic) = saved
