"""Architecture + shape configuration schema of the language models.

One ``<arch>.py`` per architecture lives in this package; each exports
``CONFIG`` built from :class:`ArchConfig`. ``get_config(name)`` resolves by
module name (``--arch`` flag of :mod:`repro_torch.launch.serve`).

A copy of the JAX package's ``configs/base.py`` with two differences:

* ``dtype`` is a ``torch.dtype``: ``torch.bfloat16`` where the reference
  says ``jnp.bfloat16``, and ``torch.float32`` in :meth:`ArchConfig.smoke`;
* ``use_kernels`` defaults to **True**. The reference documents the field
  as "Pallas path (TPU); False = portable XLA path" but none of its models
  reads it, so its behaviour does not depend on the default. Here the
  models read it: True sends prefill attention, the WKV recurrence and the
  RG-LRU recurrence through the port's hand-written kernel wrappers
  (:mod:`repro_torch.kernels`; on CPU tensors their plain versions), False
  runs the reference's portable formulation as written (``common.attention``,
  the per-step WKV loop, the RG-LRU parallel prefix) on any device. False
  is a configuration a caller chooses, never a fallback.

Every other field and default is the reference's.

Input-shape cells: every LM arch pairs with
  train_4k     seq 4096,   global batch 256  (training step)
  prefill_32k  seq 32768,  global batch 32   (inference prefill)
  decode_32k   seq 32768,  global batch 128  (single-token decode w/ KV cache)
  long_500k    seq 524288, global batch 1    (long-context decode; only
               sub-quadratic archs)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # attention
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    rope_frac: float = 1.0
    window: int = 0  # sliding-window size (0 = full)
    norm: str = "rms"  # "rms" | "layer"
    mrope_sections: tuple[int, int, int] = ()
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    n_audio_ctx: int = 1500
    # hybrid (recurrentgemma / griffin)
    attn_period: int = 0  # every `attn_period`-th block is attention
    rglru_width: int = 0
    conv1d_width: int = 4
    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_lora_mix: int = 32
    rwkv_lora_decay: int = 64
    # vlm stub frontend
    n_patches: int = 0
    d_patch: int = 1176
    dtype: Any = torch.bfloat16
    sub_quadratic: bool = False  # eligible for long_500k
    is_encdec: bool = False
    is_vlm: bool = False
    # execution knobs; scan_layers and remat change nothing in the port's
    # forward (both layer settings are one loop over the stacked axis)
    scan_layers: bool = True
    remat: str = "full"  # "none" | "full" | "dots"
    use_kernels: bool = True  # hand-written kernels; False = portable path
    constrain_acts: tuple = ()  # sharding lever; the identity here (no partitioner)
    kv_quant: bool = False  # int8 KV cache on the decode path
    kv_shard_heads_padded: bool = False  # force head-sharded KV (pad to TP)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def shapes(self) -> list[str]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.sub_quadratic:
            out.append("long_500k")
        return out

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests (field for field
        the reference's, in fp32)."""
        d_model = 64
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        if self.n_kv_heads == self.n_heads:
            n_kv = n_heads  # preserve MHA-ness (stablelm)
        kw: dict[str, Any] = dict(
            n_layers=self.n_layers and max(2, min(3, self.n_layers)),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=16,
            d_ff=96 if not self.n_experts else 32,
            vocab=256,
            window=min(self.window, 16) if self.window else 0,
            dtype=torch.float32,
            remat="none",
        )
        if self.n_experts:
            # generous capacity: a handful of tokens through random routers
            # would otherwise drop by design, not by bug
            kw.update(n_experts=min(8, self.n_experts),
                      moe_top_k=min(2, self.moe_top_k),
                      capacity_factor=8.0)
        if self.is_encdec:
            kw.update(n_encoder_layers=2, n_audio_ctx=8)
        if self.attn_period:
            kw.update(attn_period=3, n_layers=3, rglru_width=d_model)
        if self.family == "ssm":
            kw.update(rwkv_head_dim=16, rwkv_lora_mix=8, rwkv_lora_decay=8)
        if self.is_vlm:
            kw.update(n_patches=4, d_patch=12, mrope_sections=(4, 2, 2))
        return self.replace(**kw)


_REGISTRY = [
    "qwen2_vl_7b",
    "whisper_base",
    "rwkv6_7b",
    "llama3_2_1b",
    "qwen2_72b",
    "yi_9b",
    "stablelm_3b",
    "recurrentgemma_2b",
    "qwen3_moe_30b_a3b",
    "dbrx_132b",
]


def list_configs() -> list[str]:
    return list(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    mod_name = name.replace("-", "_").replace(".", "_")
    if mod_name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {_REGISTRY}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
