"""Yi-9B [arXiv:2403.04652]: llama-arch, 48L, d_model 4096, 32H GQA kv=4,
SwiGLU d_ff 11008, vocab 64000."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    d_head=128,
    rope_theta=5_000_000.0,
)
