"""Model/workload configuration system.

Every assigned architecture gets one module in this package defining a
`CONFIG` (the exact published dimensions, source cited) and a `SMOKE`
variant (2 layers, d_model<=512, <=4 experts) for CPU tests. Workload input
shapes are defined here as well; the launcher resolves (arch, shape) pairs.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

ARCH_IDS = [
    "qwen2_5_3b",
    "seamless_m4t_medium",
    "chameleon_34b",
    "hymba_1_5b",
    "dbrx_132b",
    "granite_34b",
    "qwen2_0_5b",
    "deepseek_7b",
    "mamba2_370m",
    "qwen3_moe_235b_a22b",
]

# the mixers a layer of `ModelConfig.layer_types` may have
LAYER_KINDS = ("mamba", "attention")

# canonical dashed ids (CLI --arch) -> module name
ARCH_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ARCH_ALIASES.update({a: a for a in ARCH_IDS})
# spec-sheet names
ARCH_ALIASES.update(
    {
        "qwen2.5-3b": "qwen2_5_3b",
        "seamless-m4t-medium": "seamless_m4t_medium",
        "chameleon-34b": "chameleon_34b",
        "hymba-1.5b": "hymba_1_5b",
        "dbrx-132b": "dbrx_132b",
        "granite-34b": "granite_34b",
        "qwen2-0.5b": "qwen2_0_5b",
        "deepseek-7b": "deepseek_7b",
        "mamba2-370m": "mamba2_370m",
        "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
        # served and benchmarked, not in ARCH_IDS: the JAX package has no
        # counterpart to hold it against
        "granite-4.0-h-small": "granite_4_0_h_small",
        "deepseek-v3": "deepseek_v3",
    }
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25  # 0 = dropless: every (token, expert) pair computed
    shared_d_ff: int = 0  # width of a shared SwiGLU expert every token passes; 0 = none
    # routing: "softmax" (top k of the softmax) or "sigmoid" (DeepSeek-V3's: top k
    # of sigmoid + a bias that steers the choice only, within the best
    # `topk_group` of `n_group` groups); gates renormalized over the picks
    # when `norm_topk_prob`, then times `routed_scaling_factor`
    router_scoring: str = "softmax"
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    # the first `first_k_dense` layers take a dense SwiGLU of `dense_d_ff` in
    # place of the MoE FFN
    first_k_dense: int = 0
    dense_d_ff: int = 0
    # an expert share: the layer holds `num_experts` experts, [first_expert,
    # first_expert + num_experts) of the router's `router_experts` (0 = all);
    # pairs routed elsewhere add nothing here
    first_expert: int = 0
    router_experts: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid (parallel attn + SSM heads, Hymba-style)
    hybrid: bool = False
    # the mixer of each layer, "mamba" or "attention" (Granite 4.0-H's
    # layer_types); empty = every layer as arch_type says
    layer_types: Tuple[str, ...] = ()
    # encoder-decoder (audio backbone)
    encoder_layers: int = 0
    # attention variant
    sliding_window: int = 0  # 0 = full causal; >0 = sliding-window (serving)
    rope_theta: float = 1e4
    nope: bool = False  # no positional encoding in attention (no rotary)
    # multi-head latent attention (DeepSeek-V3's MLA) where kv_lora_rank > 0:
    # low-rank q and kv paths, heads of qk_nope_head_dim + qk_rope_head_dim
    # for q/k and v_head_dim for v, one decoupled rope key shared by all heads;
    # the cache holds the latent ("v") and the roped key ("k")
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN rope scaling; factor 1 = plain rope
    yarn_factor: float = 1.0
    yarn_original_max_pos: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 1.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # scalar multipliers (Granite's); each at its default launches nothing
    embedding_multiplier: float = 1.0  # on the input embedding
    residual_multiplier: float = 1.0  # on each mixer's and FFN's output before the residual add
    attention_multiplier: float = 0.0  # the softmax scale; 0 = 1/sqrt(head_dim)
    logits_scaling: float = 1.0  # the logits are divided by it
    # execution
    use_pallas: bool = False  # hand-written Hopper kernels on CUDA tensors
    remat: str = "full"  # none | full  (training activation checkpointing)
    source: str = ""  # citation

    def __post_init__(self):
        scaled = (self.residual_multiplier, self.attention_multiplier) != (1.0, 0.0)
        if self.is_encdec and scaled:
            raise ValueError(f"{self.name}: the encoder and cross-attention take no "
                             "residual_multiplier or attention_multiplier")
        if self.mla and (self.q_lora_rank <= 0 or self.layer_types or self.hybrid):
            raise ValueError(f"{self.name}: MLA takes a q_lora_rank and every layer's mixer")
        if self.first_k_dense and not (self.mla and self.num_experts):
            raise ValueError(f"{self.name}: a dense prefix (first_k_dense) takes an MLA MoE model")
        if self.router_scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"{self.name}: router_scoring {self.router_scoring!r}")
        if self.router_scoring == "softmax" and not self.norm_topk_prob:
            raise ValueError(f"{self.name}: the softmax router renormalizes its picks")
        if self.num_experts and (self.n_router % self.n_group or self.topk_group > self.n_group
                                 or self.first_expert + self.num_experts > self.n_router):
            raise ValueError(f"{self.name}: experts [{self.first_expert}, "
                             f"{self.first_expert + self.num_experts}) of {self.n_router} "
                             f"in {self.n_group} groups, {self.topk_group} kept")
        if self.num_experts and not self.dropless and (
                self.router_scoring != "softmax" or self.expert_share):
            raise ValueError(f"{self.name}: the sigmoid router and an expert share run "
                             "on the dropless MoE (moe_capacity_factor 0)")

    @property
    def resolved_head_dim(self) -> int:
        if self.num_heads == 0:  # attention-free
            return 0
        return self.head_dim or self.d_model // self.num_heads

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def n_router(self) -> int:
        """The router's width: every expert, held here or not."""
        return self.router_experts or self.num_experts

    @property
    def expert_share(self) -> bool:
        """Whether the MoE layers hold only some of the router's experts."""
        return self.n_router != self.num_experts

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def dropless(self) -> bool:
        return self.num_experts > 0 and self.moe_capacity_factor <= 0

    def layer_slots(self) -> Tuple[Tuple[str, int], ...]:
        """(kind, index in that kind's stack) of each layer of `layer_types`."""
        seen: Dict[str, int] = {}
        out = []
        for kind in self.layer_types:
            if kind not in LAYER_KINDS:
                raise ValueError(f"{self.name}: layer type {kind!r}, not one of {LAYER_KINDS}")
            out.append((kind, seen.get(kind, 0)))
            seen[kind] = seen.get(kind, 0) + 1
        return tuple(out)

    def layers_of(self, kind: str) -> int:
        return sum(t == kind for t in self.layer_types)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for MODEL_FLOPS = 6 N D) ----------------------
    def param_count(self, *, active_only: bool = False) -> int:
        if self.layer_types:
            return self._param_count_by_kind(active_only)
        if self.mla:
            return self._param_count_mla(active_only)
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, K, Hd = self.num_heads, self.num_kv_heads, self.resolved_head_dim
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += D * V
        per_layer = 0
        if self.arch_type != "ssm":
            attn = D * H * Hd + 2 * D * K * Hd + H * Hd * D
            if self.qkv_bias:
                attn += (H + 2 * K) * Hd
            per_layer += attn
        if self.num_experts > 0:
            e = self.experts_per_token if active_only else self.num_experts
            per_layer += D * self.num_experts  # router (always resident)
            per_layer += e * (3 * D * F)
        elif self.arch_type != "ssm":
            per_layer += 3 * D * F
        if self.arch_type in ("ssm", "hybrid") or self.ssm_state > 0:
            di, N, nh = self.ssm_d_inner, self.ssm_state, self.ssm_nheads
            ssm = D * (2 * di + 2 * N + nh) + di * D  # in/out proj (+B,C,dt)
            ssm += self.ssm_conv * (di + 2 * N) + nh * 2  # conv + A,D params
            per_layer += ssm
        n += L * per_layer
        n += 2 * D * L  # norms
        if self.is_encdec:
            # encoder layers: self-attn + ffn; plus decoder cross-attn
            enc = self.encoder_layers * (D * H * Hd * 2 + 2 * D * K * Hd + 3 * D * F + 2 * D)
            xattn = L * (D * H * Hd + 2 * D * K * Hd + H * Hd * D + D)
            n += enc + xattn
        return n

    def _param_count_mla(self, active_only: bool) -> int:
        """Every leaf of an MLA model: the mixer and norms over all layers,
        the dense FFN over the first `first_k_dense`, the (held) experts,
        router and shared expert over the rest."""
        D, V, L, H = self.d_model, self.vocab_size, self.num_layers, self.num_heads
        qr, r, dr = self.q_lora_rank, self.kv_lora_rank, self.qk_rope_head_dim
        dq, dv = self.qk_nope_head_dim + dr, self.v_head_dim
        mla = D * qr + qr + qr * H * dq + D * (r + dr) + r + r * H * (self.qk_nope_head_dim + dv)
        mla += H * dv * D
        e = min(self.experts_per_token, self.num_experts) if active_only else self.num_experts
        moe = D * self.n_router + e * 3 * D * self.d_ff + 3 * D * self.shared_d_ff
        if self.router_scoring == "sigmoid":
            moe += self.n_router  # the choice's bias
        n = V * D * (1 if self.tie_embeddings else 2) + D
        n += L * (2 * D + mla) + self.first_k_dense * 3 * D * self.dense_d_ff
        return n + (L - self.first_k_dense) * moe

    def _param_count_by_kind(self, active_only: bool) -> int:
        """Every leaf of a `layer_types` model: each mixer over its own
        layers, norms and the (MoE) FFN over all of them."""
        D, V, L = self.d_model, self.vocab_size, self.num_layers
        H, K, Hd = self.num_heads, self.num_kv_heads, self.resolved_head_dim
        attn = D * H * Hd + 2 * D * K * Hd + H * Hd * D
        if self.qkv_bias:
            attn += (H + 2 * K) * Hd
        di, N, nh = self.ssm_d_inner, self.ssm_state, self.ssm_nheads
        cd = di + 2 * N
        mamba = D * (2 * di + 2 * N + nh) + di * D  # in/out proj
        mamba += (self.ssm_conv + 1) * cd + 3 * nh + di  # conv w and b, dt_bias, A_log, D, norm
        if self.num_experts > 0:
            e = self.experts_per_token if active_only else self.num_experts
            ffn = D * self.num_experts + e * 3 * D * self.d_ff
        else:
            ffn = 3 * D * self.d_ff
        ffn += 3 * D * self.shared_d_ff
        n = V * D * (1 if self.tie_embeddings else 2) + D  # embedding(s), final norm
        n += L * (2 * D + ffn)
        return n + self.layers_of("attention") * attn + self.layers_of("mamba") * mamba


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# Serving window used when a full-attention arch runs long_500k (DESIGN.md
# §Arch-applicability: the sub-quadratic carve-out).
LONG_CONTEXT_WINDOW = 8_192


def get_config(arch: str) -> ModelConfig:
    mod_name = ARCH_ALIASES.get(arch)
    if mod_name is None:
        raise ValueError(f"unknown arch {arch!r}; known: {sorted(ARCH_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod_name = ARCH_ALIASES.get(arch)
    if mod_name is None:
        raise ValueError(f"unknown arch {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Adapt the model config to the workload shape (serving windows)."""
    if shape.kind == "decode" and shape.seq_len > 100_000:
        if cfg.arch_type == "ssm":
            return cfg  # attention-free: natively O(1)-state decode
        if cfg.sliding_window == 0 or cfg.sliding_window > LONG_CONTEXT_WINDOW:
            return cfg.with_(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg
