"""mamba2-370m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

SMOKE = CONFIG.with_(
    name="mamba2-370m-smoke", num_layers=2, d_model=256, vocab_size=1024,
    ssm_state=32,
)
