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
    moe_capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid (parallel attn + SSM heads, Hymba-style)
    hybrid: bool = False
    # encoder-decoder (audio backbone)
    encoder_layers: int = 0
    # attention variant
    sliding_window: int = 0  # 0 = full causal; >0 = sliding-window (serving)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # execution
    use_pallas: bool = False  # hand-written Hopper kernels on CUDA tensors
    remat: str = "full"  # none | full  (training activation checkpointing)
    source: str = ""  # citation

    @property
    def resolved_head_dim(self) -> int:
        if self.num_heads == 0:  # attention-free
            return 0
        return self.head_dim or self.d_model // self.num_heads

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

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for MODEL_FLOPS = 6 N D) ----------------------
    def param_count(self, *, active_only: bool = False) -> int:
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
