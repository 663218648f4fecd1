"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
    rope_theta=5e5,
    source="hf:databricks/dbrx-base",
)

SMOKE = CONFIG.with_(
    name="dbrx-132b-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, d_ff=256, vocab_size=1024, num_experts=4,
    experts_per_token=2,
)
