"""granite-4.0-h-small [hybrid] — 32B-A9B: 36 Mamba2 and 4 NoPE GQA
attention layers by `layer_types`, every layer ending in a dropless
72-expert top-10 MoE FFN with a shared expert
[hf:ibm-granite/granite-4.0-h-small config.json, model_type
granitemoehybrid]."""
from .base import ModelConfig

# attention at layers 5, 15, 25 and 35, Mamba2 everywhere else
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba" for i in range(40))

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    arch_type="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,  # per-expert width (config.json's intermediate_size)
    vocab_size=100352,
    num_experts=72,
    experts_per_token=10,
    moe_capacity_factor=0.0,  # dropless
    shared_d_ff=1536,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=128,  # the SSD kernel's largest; config.json's mamba_chunk_size is 256
    layer_types=LAYER_TYPES,
    nope=True,
    norm_eps=1e-5,
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    source="hf:ibm-granite/granite-4.0-h-small (config.json)",
)

SMOKE = CONFIG.with_(
    name="granite-4.0-h-small-smoke", num_layers=3, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=128, vocab_size=1024, num_experts=4,
    experts_per_token=2, shared_d_ff=256, ssm_state=32,
    layer_types=("mamba", "attention", "mamba"),
)
