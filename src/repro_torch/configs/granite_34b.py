"""granite-34b [dense] — llama-arch code model, MQA (kv=1) [arXiv:2405.04324]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    arch_type="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    source="arXiv:2405.04324",
)

SMOKE = CONFIG.with_(
    name="granite-34b-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=1, d_ff=512, vocab_size=1024,
)
