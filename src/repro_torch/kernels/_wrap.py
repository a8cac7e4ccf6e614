"""Checks and launch plumbing shared by the kernel wrappers.

Every wrapper first refuses operands that would need a gradient (no kernel
has a backward: an output filled by a launch has no ``grad_fn``, so the
gradient would be dropped, not raised), then checks device, dtype, shape
and contiguity and raises on what its kernel does not take, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch's error code is not 0, and adds one to
its launch count where — and only where — it launches. The wrappers take CUDA tensors only; CPU tensors
go through :mod:`repro_torch.kernels.ops`, which dispatches on the device.
"""

from __future__ import annotations

import ctypes

import torch

PTR, INT, LL, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would need a gradient through ``kernel``: grad
    mode is on and an operand requires one."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward: its output would carry no "
            "gradient; train through the portable route (use_kernels=False, "
            "attn_impl='direct') or call it under torch.no_grad()")


def cuda_operand(name: str, t, dtypes) -> None:
    """``t`` is a CUDA tensor of one of ``dtypes``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(
            f"{name} is on {t.device}: the CUDA kernels take CUDA tensors only "
            "(repro_torch.kernels.ops dispatches CPU tensors to the plain versions)"
        )
    if t.dtype not in dtypes:
        names = " or ".join(str(d).split(".")[-1] for d in dtypes)
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {names}")


def check(name: str, t, shape, dtype, device) -> None:
    """``t`` is a contiguous tensor of exactly this shape, dtype and device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def declare(lib: ctypes.CDLL, error_string: str, funcs: dict) -> dict:
    """Declare the C signatures of ``funcs`` ({(key): (symbol, argtypes)},
    each returning a cudaError_t code) and of the library's error-string
    function; returns {key: function}."""
    fn = getattr(lib, error_string)
    fn.restype, fn.argtypes = ctypes.c_char_p, [ctypes.c_int]
    out = {}
    for key, (symbol, argtypes) in funcs.items():
        f = getattr(lib, symbol)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        out[key] = f
    return out


def launch(name: str, fn, args, device: torch.device, error_string) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream; raise if
    the launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    if code != 0:
        msg = error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")
