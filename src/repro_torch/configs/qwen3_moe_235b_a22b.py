"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, fine-grained
[hf:Qwen/Qwen3-30B-A3B family]. This is the paper's own evaluation model
(Tables 2 and 3: Qwen3-235B-A22B-Instruct-2507)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,  # per-expert ffn width (fine-grained experts)
    vocab_size=151936,
    head_dim=128,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B (family card)",
)

SMOKE = CONFIG.with_(
    name="qwen3-moe-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=1024, head_dim=64,
    num_experts=4, experts_per_token=2,
)
