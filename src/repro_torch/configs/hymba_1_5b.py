"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].

Hymba fuses attention heads and SSM heads *in parallel* within each layer;
most attention is sliding-window. Meta-tokens are omitted (noted in
DESIGN.md) — they do not change the data-movement or sharding structure.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    hybrid=True,
    sliding_window=2048,
    source="arXiv:2411.13676",
)

SMOKE = CONFIG.with_(
    name="hymba-1.5b-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, d_ff=512, vocab_size=1024, ssm_state=16,
    sliding_window=128,
)
