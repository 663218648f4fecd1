"""qwen2.5-3b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B (family card)",
)

SMOKE = CONFIG.with_(
    name="qwen2.5-3b-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, d_ff=512, vocab_size=1024,
)
