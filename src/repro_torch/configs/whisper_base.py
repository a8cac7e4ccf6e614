"""Whisper-base [arXiv:2212.04356]: encoder-decoder, 6+6 layers, d_model 512,
8 MHA heads, d_ff 2048, vocab 51865. The conv frontend is a stub —
``input_specs`` provides precomputed mel-frame embeddings (B, 1500, 512).
LayerNorm (pre-LN), sinusoidal encoder positions, learned decoder positions.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,  # decoder layers
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    norm="layer",
    rope_theta=0.0,  # no rotary — absolute positions
    n_audio_ctx=1500,
    is_encdec=True,
)
