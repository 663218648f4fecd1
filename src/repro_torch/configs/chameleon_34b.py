"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].

Backbone only: the VQ-VAE image tokenizer is a stub; image patches arrive as
ordinary token ids interleaved with text (early fusion), so input_specs()
provides an int32 token stream over the unified 65536 vocab.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    source="arXiv:2405.09818",
)

SMOKE = CONFIG.with_(
    name="chameleon-34b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, d_ff=512, vocab_size=1024,
)
