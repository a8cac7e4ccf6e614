"""Qwen2-VL-7B language backbone [arXiv:2409.12191].

M-RoPE (temporal/height/width rotary sections 16/24/24 over head_dim 128),
QKV bias, GQA kv=4. The vision frontend is a stub per the assignment:
``input_specs`` provides precomputed patch embeddings (B, n_patches, d_patch)
that the model projects and prepends to the text sequence.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    d_head=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    is_vlm=True,
    n_patches=256,
    d_patch=1176,
)
