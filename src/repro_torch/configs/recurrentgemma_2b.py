"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427]: 26 residual blocks with
RG-LRU recurrence + local sliding-window MQA in a 2:1 pattern (rec, rec, attn
— attention every 3rd block), d_model 2560, 10H kv=1 (head_dim 256), GeGLU
d_ff 7680, vocab 256000, window 2048. Sub-quadratic -> runs long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    d_head=256,
    window=2048,
    attn_period=3,
    rglru_width=2560,
    conv1d_width=4,
    rope_theta=10_000.0,
    sub_quadratic=True,
)
