"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L, d_model 2048, 32H GQA kv=4
(head_dim 128), MoE with 128 experts top-8, per-expert SwiGLU d_ff 768,
vocab 151936."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151936,
    d_head=128,
    rope_theta=1_000_000.0,
    n_experts=128,
    moe_top_k=8,
)
