"""qwen2-0.5b [dense] — GQA with QKV bias [arXiv:2407.10671]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    arch_type="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="arXiv:2407.10671",
)

SMOKE = CONFIG.with_(
    name="qwen2-0.5b-smoke", num_layers=2, d_model=224, num_heads=4,
    num_kv_heads=2, d_ff=448, vocab_size=1024,
)
