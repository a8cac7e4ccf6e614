"""Architecture registry: config -> model instance, input specs and batches.

Port of the JAX package's ``models/registry.py``. ``input_specs(cfg,
shape)`` returns **meta** tensors (shape and dtype, no storage) for every
model input of the given cell; ``make_batch`` materialises a small real
batch, drawing from numpy's ``default_rng(seed)`` exactly as the reference
does, so both packages get the same tokens, frames and patches from one
seed.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.rglru import RecurrentGemma
from repro_torch.models.rwkv6 import RWKV6
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.whisper import Whisper

ARCH_REGISTRY = {
    "dense": DecoderLM,
    "moe": DecoderLM,
    "vlm": DecoderLM,
    "ssm": RWKV6,
    "hybrid": RecurrentGemma,
    "audio": Whisper,
}


def build_model(cfg: ArchConfig):
    return ARCH_REGISTRY[cfg.family](cfg)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec | str) -> dict[str, Any]:
    """Inputs of the (arch, shape) cell as meta tensors.

    train  : {tokens, labels [, frames/patches]}
    prefill: {tokens [, frames/patches]}
    decode : {tokens (B,1)} — caches come from ``model.cache_specs``.
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, t = shape.global_batch, shape.seq_len
    itok = torch.int32
    specs: dict[str, Any] = {}
    if shape.kind == "train":
        specs["tokens"] = _meta((b, t), itok)
        specs["labels"] = _meta((b, t), itok)
    elif shape.kind == "prefill":
        specs["tokens"] = _meta((b, t), itok)
    else:  # decode
        specs["tokens"] = _meta((b, 1), itok)
    if cfg.is_encdec and shape.kind != "decode":
        specs["frames"] = _meta((b, cfg.n_audio_ctx, cfg.d_model), cfg.dtype)
    if cfg.is_vlm and shape.kind != "decode":
        specs["patches"] = _meta((b, cfg.n_patches, cfg.d_patch), torch.float32)
    return specs


def make_batch(cfg: ArchConfig, *, batch: int, seq: int, kind: str = "train",
               seed: int = 0, device: DeviceLike = None) -> dict[str, Any]:
    """Small concrete batch on ``device`` (``None``: the GPU) — mirrors
    input_specs, with the reference's draws from ``default_rng(seed)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)

    out: dict[str, Any] = {}
    if kind == "decode":
        out["tokens"] = tensor(rng.integers(0, cfg.vocab, (batch, 1)), torch.int32)
    else:
        out["tokens"] = tensor(rng.integers(0, cfg.vocab, (batch, seq)), torch.int32)
        if kind == "train":
            out["labels"] = tensor(rng.integers(0, cfg.vocab, (batch, seq)),
                                   torch.int32)
    if cfg.is_encdec and kind != "decode":
        out["frames"] = tensor(rng.normal(size=(batch, cfg.n_audio_ctx, cfg.d_model)),
                               cfg.dtype)
    if cfg.is_vlm and kind != "decode":
        out["patches"] = tensor(rng.normal(size=(batch, cfg.n_patches, cfg.d_patch)),
                                torch.float32)
    return out
