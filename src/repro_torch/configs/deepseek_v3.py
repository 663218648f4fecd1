"""deepseek-v3 [moe] — 671B-A37B: 61 layers of multi-head latent attention
(MLA: q through a 1536-wide latent, K/V from one shared 512-wide latent and
a decoupled 64-dim rope key under YaRN), the first 3 with a dense SwiGLU
FFN and the other 58 with 256 sigmoid-routed experts, top-8 within the best
4 of 8 groups, gates times 2.5, and one shared expert
[hf:deepseek-ai/DeepSeek-V3 config.json, model_type deepseek_v3]. The MTP
module (num_nextn_predict_layers 1) serves speculative decoding and is not
part of this model."""
import math

from .base import ModelConfig

# YaRN's attention scale: mscale = 0.1 mscale_all_dim ln(factor) + 1 enters
# the softmax scale squared; cos and sin take mscale / mscale_all_dim = 1
_FACTOR, _MSCALE_ALL_DIM = 40.0, 1.0
_QK_HEAD_DIM = 128 + 64
SOFTMAX_SCALE = (0.1 * _MSCALE_ALL_DIM * math.log(_FACTOR) + 1.0) ** 2 / math.sqrt(_QK_HEAD_DIM)

CONFIG = ModelConfig(
    name="deepseek-v3",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=_QK_HEAD_DIM,
    d_ff=2048,  # per-expert width (config.json's moe_intermediate_size)
    vocab_size=129280,
    num_experts=256,
    experts_per_token=8,
    moe_capacity_factor=0.0,  # dropless
    shared_d_ff=2048,  # n_shared_experts 1 of moe_intermediate_size
    router_scoring="sigmoid",
    n_group=8,
    topk_group=4,
    routed_scaling_factor=2.5,
    norm_topk_prob=True,
    first_k_dense=3,
    dense_d_ff=18432,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=1e4,
    yarn_factor=_FACTOR,
    yarn_original_max_pos=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=1.0,
    yarn_mscale_all_dim=_MSCALE_ALL_DIM,
    attention_multiplier=SOFTMAX_SCALE,
    norm_eps=1e-6,
    tie_embeddings=False,
    source="hf:deepseek-ai/DeepSeek-V3 (config.json)",
)

# 1 dense and 2 MoE layers; 16 experts in 4 groups, top-4 within 2; the
# share tests cut it into 4 shares of 4 experts
SMOKE = CONFIG.with_(
    name="deepseek-v3-smoke", num_layers=3, d_model=256, num_heads=4, num_kv_heads=4,
    head_dim=48, d_ff=64, vocab_size=1024, num_experts=16, experts_per_token=4,
    shared_d_ff=64, n_group=4, topk_group=2, first_k_dense=1, dense_d_ff=256,
    q_lora_rank=96, kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
    attention_multiplier=(0.1 * math.log(_FACTOR) + 1.0) ** 2 / math.sqrt(48),
)
