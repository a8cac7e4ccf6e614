"""RWKV-6 (Finch) 7B [arXiv:2404.05892]: attention-free, data-dependent decay
linear recurrence. 32 layers, d_model 4096 (64 heads of 64), channel-mix
d_ff 14336, vocab 65536. Sub-quadratic -> runs the long_500k cell.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    rwkv_head_dim=64,
    rwkv_lora_mix=32,
    rwkv_lora_decay=64,
    sub_quadratic=True,
)
