"""seamless-m4t-medium [audio] — enc-dec multimodal backbone [arXiv:2308.11596].

Backbone only: the mel-spectrogram + conv feature extractor frontend is a
stub; input_specs() provides precomputed frame embeddings (B, S_enc, D).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    num_layers=12,  # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    source="arXiv:2308.11596",
)

SMOKE = CONFIG.with_(
    name="seamless-m4t-medium-smoke", num_layers=2, encoder_layers=2,
    d_model=256, num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=1024,
)
