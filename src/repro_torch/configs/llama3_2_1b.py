"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B]: 16L, d_model 2048, 32H GQA kv=8,
SwiGLU d_ff 8192, vocab 128256, rope theta 500k, tied embeddings."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    d_head=64,
    rope_theta=500_000.0,
)
