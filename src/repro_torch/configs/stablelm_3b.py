"""StableLM-3B [hf:stabilityai/stablelm-2 family]: 32L, d_model 2560,
32H MHA (kv=32), d_ff 6912, vocab 50304, LayerNorm, partial rotary (25%)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    d_head=80,
    norm="layer",
    rope_theta=10_000.0,
    rope_frac=0.25,
)
