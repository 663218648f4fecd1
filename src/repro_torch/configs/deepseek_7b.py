"""deepseek-7b [dense] — llama-arch, full MHA (kv=32) [arXiv:2401.02954]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    arch_type="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    source="arXiv:2401.02954",
)

SMOKE = CONFIG.with_(
    name="deepseek-7b-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=4, d_ff=512, vocab_size=1024,
)
