"""DBRX-132B [hf:databricks/dbrx-base]: 40L, d_model 6144, 48H GQA kv=8
(head_dim 128), fine-grained MoE with 16 experts top-4, per-expert d_ff
10752, vocab 100352, LayerNorm."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    d_head=128,
    norm="layer",
    rope_theta=500_000.0,
    n_experts=16,
    moe_top_k=4,
)
