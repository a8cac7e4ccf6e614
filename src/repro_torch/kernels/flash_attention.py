"""Wrapper of the hand-written CUDA kernel in ``csrc/flash_attention.cu``.

Counterpart of the Pallas function ``flash_attention`` in the JAX package's
``kernels/flash_attention.py``, with the same public layout: q (B, H, Tq,
D), k and v (B, H, Tk, D), contiguous, fp32 or bf16, D up to 128. Unlike
the Pallas wrapper it takes any Tk, causal or not (the kernel masks the
ragged key tail itself), and it pads nothing in device memory.

The wrapper checks device, dtype, shape and contiguity and raises on what
the kernel does not take, allocates its output with ``torch.empty``,
launches on PyTorch's current stream without synchronising, checks the
launch's error code, and adds one to :data:`LAUNCHES` where — and only
where — it launches. The kernel has no backward: a call that would need a
gradient raises (the attention family trains through its direct
attention). CPU tensors go through :mod:`repro_torch.kernels.ops`, which
dispatches on the tensor's device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: launches since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {"flash_attention": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_PTR] * 4 + [_LL, _INT, _INT, _INT, _INT, _INT, ctypes.c_float,
                          _PTR]
_FUNCS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _lib() -> ctypes.CDLL:
    """The loaded kernel library, with every function's C signature
    declared (built at the first call)."""
    lib = _build.load()["flash_attention"]
    if not _FUNCS:
        lib.flash_error_string.restype = ctypes.c_char_p
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_max_d.restype = ctypes.c_int
        lib.flash_max_d.argtypes = []
        for dtype, suffix in _SUFFIX.items():
            fn = getattr(lib, f"flash_attention_{suffix}")
            fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
            _FUNCS[dtype] = fn
    return lib


def _check(name: str, t, shape, dtype, device) -> None:
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D) + mask) v`` in one launch; see the module
    docstring for what it takes."""
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"q must be a torch.Tensor, got {type(q).__name__}")
    if q.device.type != "cuda":
        raise ValueError(
            f"q is on {q.device}: the CUDA kernels take CUDA tensors only "
            "(repro_torch.kernels.ops dispatches CPU tensors to the plain versions)"
        )
    if q.dtype not in _SUFFIX:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, Tq, D), got shape {tuple(q.shape)}")
    b, h, tq, d = q.shape
    if not isinstance(k, torch.Tensor) or k.dim() != 4:
        raise ValueError("k must be a (B, H, Tk, D) tensor")
    tk = k.shape[2]
    _check("q", q, (b, h, tq, d), q.dtype, q.device)
    _check("k", k, (b, h, tk, d), q.dtype, q.device)
    _check("v", v, (b, h, tk, d), q.dtype, q.device)
    max_d = _lib().flash_max_d()
    if not 1 <= d <= max_d:
        raise ValueError(f"head dim D={d} outside the kernel's range 1..{max_d}")
    if tk < 1:
        raise ValueError("k and v need at least one key")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash_attention kernel has no backward; train through the "
            "direct attention (attn_impl='direct')"
        )
    out = torch.empty_like(q)
    if out.numel():
        fn = _FUNCS[q.dtype]
        scale = 1.0 / math.sqrt(d)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      b * h, tq, tk, d, int(causal), int(window), scale, stream)
        if code != 0:
            msg = _lib().flash_error_string(code).decode()
            raise RuntimeError(f"flash_attention launch failed: {msg} (cudaError {code})")
        LAUNCHES["flash_attention"] += 1
    return out
