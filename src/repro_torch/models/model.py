"""One model definition for every family of the reference, in torch.

Counterpart of `repro.models.model`, parameterized by ModelConfig:
  dense / vlm      -> GQA attention + SwiGLU FFN decoder
  moe              -> GQA attention + top-k expert FFN (sorted dispatch)
  ssm              -> Mamba2 SSD mixer blocks (attention-free)
  hybrid           -> parallel attention + SSM heads per layer + FFN; with
                      `layer_types`, a Mamba2 mixer or attention by layer,
                      each followed by the FFN (Granite 4.0-H)
  MLA (kv_lora_rank > 0) -> multi-head latent attention in every layer
                      (DeepSeek-V3), a dense FFN in the first
                      `first_k_dense` layers and the MoE FFN after
  audio (enc-dec)  -> bidirectional encoder over frame embeddings + causal
                      decoder with cross-attention

Parameters keep the reference's stacked-dict layout, `{"embed",
"final_norm", "layers": {name: (L, ...)}}` (plus "lm_head" when embeddings
are untied, and "encoder": {"layers", "final_norm"} for enc-dec), so
`params_from_numpy` maps the reference's pytree onto it leaf for leaf. The
reference's `lax.scan` over layers is a Python loop over the layer axis.
Entry points:

  param_shapes / init_params      parameters
  abstract_params                 parameters as meta tensors (dry-run currency)
  forward                         causal LM forward (+ MoE aux losses)
  loss_fn                         training loss: token CE (+ MoE aux terms)
  prefill_forward                 serving prefill, returns the decode cache
  init_cache / decode_step        decode caches and the single-token step
  cache_shapes                    decode caches as meta tensors
  prefill                         replay prefill through decode_step
  encode                          audio encoder (enc-dec only)
  DecoderLM                       an nn.Module holding the parameters

SSM layers are Mamba2 mixers (`ssm.py`); hybrid layers run attention and
the mixer in parallel from the same input and average them. MoE layers
call `moe.moe_ffn_ep` in the prefill and training passes and
`moe.moe_ffn_sorted` in the decode step, as the reference's do; without a
mesh both are the sorted dispatch. A dropless MoE calls
`moe.moe_ffn_dropless` in both, and a shared expert adds its SwiGLU.

Under `layer_types` each mixer's leaves are stacked over the layers of
its kind only ("ssm_*" over the Mamba2 layers, "wq".."wo" over the
attention layers), the norms and the FFN over every layer; the decode
cache likewise holds "k"/"v" for the attention layers and "ssm_state"/
"conv_buf" for the Mamba2 layers. NoPE skips the rotary embedding; the
scalar multipliers (embedding, residual, softmax scale, logits) launch
nothing at their defaults.

MLA (`_mla_block`, `_mla_step`): q = rms(x W_qa) W_qb and the latent [c |
k_pe] = x W_kva, c normed, split per head into [q_nope | q_pe]; RoPE (YaRN
frequencies where `yarn_factor` > 1) on q_pe and on k_pe, one head shared
by all. Prefill takes the expanded form, [k_nope | v] = c W_kvb per head and
k = [k_nope | k_pe], through `prefill_attention` at q/k head dim dn + dr and
v head dim dv; a decode step the absorbed form over the latent cache
(`attention.attend_latent`). The cache keeps per layer "v" = c (L, B, S, 1,
kv_lora_rank) and "k" = the roped k_pe (L, B, S, 1, qk_rope_head_dim): in
the absorbed view K = [v | k] and V = v. Under `first_k_dense` the dense
FFN's leaves ("dense_gate", "dense_up", "dense_down") stack over the first
layers and the MoE FFN's over the others.

Under `repro_torch.sharding.ctx.activation_sharding(mesh)`, with the
parameters as DTensors (`sharding.rules.param_shardings`), every entry
point runs sharded: the reference's `constrain` calls stand at their
counterparts and redistribute the activations, and the kernels run on local
shards.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import DeviceLike, default_device
from ..kernels.ssm_step import kernel as ssm_step_kernel
from ..obs import spans as _spans
from ..sharding.ctx import constrain, hold_layout, split_dim
from .attention import (attend_cached, attend_cross, attend_full, attend_latent, cache_update,
                        prefill_attention)
from .common import (apply_rope, cross_entropy, dense_init, embed_init, rms_norm,
                     rope_angles, swiglu, yarn_inv_freq, yarn_mscale)
from .moe import moe_ffn_dropless, moe_ffn_ep, moe_ffn_sorted, moe_param_shapes
from .ssm import mamba2_mixer, mamba2_mixer_step, mixer_param_shapes

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _attn_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    D, H, K, Hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s = {
        "wq": (D, H * Hd),
        "wk": (D, K * Hd),
        "wv": (D, K * Hd),
        "wo": (H * Hd, D),
    }
    if cfg.qkv_bias:
        s.update({"bq": (H * Hd,), "bk": (K * Hd,), "bv": (K * Hd,)})
    return s


def _ffn_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    D = cfg.d_model
    return {"w_gate": (D, cfg.d_ff), "w_up": (D, cfg.d_ff), "w_down": (cfg.d_ff, D)}


def _mla_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    D, H, qr, r = cfg.d_model, cfg.num_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"wq_a": (D, qr), "q_norm": (qr,), "wq_b": (qr, H * (dn + dr)),
            "wkv_a": (D, r + dr), "kv_norm": (r,), "wkv_b": (r, H * (dn + dv)),
            "wo": (H * dv, D)}


# the dense FFN of the first `first_k_dense` layers, stacked over them
_DENSE_LEAVES = {"dense_gate": "w_gate", "dense_up": "w_up", "dense_down": "w_down"}


# the leaves of each mixer kind under `layer_types`, stacked over that kind's layers
_ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _leaf_kind(name: str) -> str:
    """The layer kind whose stack holds leaf `name` ("" = every layer)."""
    if name.startswith("ssm_"):
        return "mamba"
    return "attention" if name in _ATTN_LEAVES else ""


def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    D = cfg.d_model
    s: Dict[str, tuple] = {"ln1": (D,)}
    if cfg.mla:
        s.update(_mla_shapes(cfg))
        s["ln2"] = (D,)
        s.update(moe_param_shapes(cfg) if cfg.num_experts > 0 else _ffn_shapes(cfg))
        if cfg.first_k_dense:
            Fd = cfg.dense_d_ff
            s.update({"dense_gate": (D, Fd), "dense_up": (D, Fd), "dense_down": (Fd, D)})
        return s
    if cfg.layer_types:
        s.update(_attn_shapes(cfg))
        s.update(mixer_param_shapes(cfg))
        s["ln2"] = (D,)
        s.update(moe_param_shapes(cfg) if cfg.num_experts > 0 else _ffn_shapes(cfg))
        return s
    if cfg.arch_type == "ssm":
        s.update(mixer_param_shapes(cfg))
        return s
    s.update(_attn_shapes(cfg))
    if cfg.hybrid:
        s.update(mixer_param_shapes(cfg))
    s["ln2"] = (D,)
    s.update(moe_param_shapes(cfg) if cfg.num_experts > 0 else _ffn_shapes(cfg))
    if cfg.is_encdec:
        s["lnx"] = (D,)
        s.update({f"x{k}": v for k, v in _attn_shapes(cfg).items() if not k.startswith("b")})
    return s


def _encoder_layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    D = cfg.d_model
    return {"ln1": (D,), "ln2": (D,), **_attn_shapes(cfg), **_ffn_shapes(cfg)}


def _stack_len(cfg: ModelConfig, name: str) -> int:
    if cfg.first_k_dense and name in _DENSE_LEAVES:
        return cfg.first_k_dense
    if cfg.first_k_dense and name in _moe_leaves(cfg):
        return cfg.num_layers - cfg.first_k_dense
    kind = _leaf_kind(name) if cfg.layer_types else ""
    return cfg.layers_of(kind) if kind else cfg.num_layers


def _moe_leaves(cfg: ModelConfig) -> frozenset:
    return frozenset(moe_param_shapes(cfg)) if cfg.num_experts > 0 else frozenset()


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.vocab_size
    out: Dict[str, Any] = {
        "embed": (V, D),
        "final_norm": (D,),
        "layers": {k: (_stack_len(cfg, k),) + v for k, v in _layer_shapes(cfg).items()},
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = (D, V)
    if cfg.is_encdec:
        Le = cfg.encoder_layers
        out["encoder"] = {
            "layers": {k: (Le,) + v for k, v in _encoder_layer_shapes(cfg).items()},
            "final_norm": (D,),
        }
    return out


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=torch.bfloat16,
                device: DeviceLike = None) -> Params:
    """Random parameters on `device` (CUDA unless the caller asks for the
    CPU): matrices Normal(0, fan_in**-0.5) with fan_in = shape[-2] (the
    router, the (E, D, F)/(E, F, D) expert leaves and the cross-attention
    leaves too), embeddings Normal(0, 0.02), norms ones, biases zeros, and the reference's Mamba2 values for the SSM
    leaves (A_log = log(1..nheads), D = 1, dt_bias = -2, conv weights
    Normal(0, 0.1), conv bias 0). `gen` must live on that device. Drawn leaf by
    leaf in sorted-key order (the encoder's subtree in its place among the
    top-level keys); a torch generator does not give the
    reference's jax.random bits (tests convert the reference's parameters
    with `params_from_numpy` instead)."""
    dev = default_device(device)
    if gen.device.type != dev.type or (
            dev.index is not None and gen.device.index not in (None, dev.index)):
        raise ValueError(f"init_params: generator on {gen.device}, parameters asked on {dev}")
    shapes = param_shapes(cfg)

    def mk(name: str, shape: tuple) -> torch.Tensor:
        if name.startswith("ln") or name in ("final_norm", "ssm_norm", "ssm_D", "q_norm",
                                              "kv_norm"):
            return torch.ones(shape, dtype=dtype, device=dev)
        if name in ("bq", "bk", "bv", "ssm_conv_b", "router_bias"):
            return torch.zeros(shape, dtype=dtype, device=dev)
        if name == "ssm_dt_bias":
            return torch.full(shape, -2.0, dtype=dtype, device=dev)  # softplus ~ 0.12
        if name == "ssm_A_log":
            a0 = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=dev))
            return a0.expand(shape).to(dtype).contiguous()
        if name == "ssm_conv_w":
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
            return (w * 0.1).to(dtype)
        if name == "embed":
            return embed_init(gen, shape, dtype)
        return dense_init(gen, shape[-2], shape, dtype)

    def build(tree: Dict[str, Any]) -> Params:
        return {name: build(sub) if isinstance(sub, dict) else mk(name, sub)
                for name, sub in sorted(tree.items())}

    return build(shapes)


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """`param_shapes(cfg)` as meta tensors of `dtype` (no allocation): the
    dry run's currency, as the reference's ShapeDtypeStruct tree is."""
    def build(tree: Dict[str, Any]) -> Params:
        return {name: build(sub) if isinstance(sub, dict)
                else torch.empty(sub, dtype=dtype, device="meta") for name, sub in tree.items()}

    return build(param_shapes(cfg))


def _frozen(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})


class DecoderLM(nn.Module):
    """The parameters as an `nn.Module`, frozen. `tree()` hands the
    functional entry points their dict. Training works on that functional
    tree (`repro_torch.training`), as the reference's does, so the module
    never holds a second, trainable copy."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.top = _frozen({k: v for k, v in params.items() if k not in ("layers", "encoder")})
        self.layers = _frozen(params["layers"])
        if "encoder" in params:
            self.encoder_layers = _frozen(params["encoder"]["layers"])
            self.encoder_top = _frozen({"final_norm": params["encoder"]["final_norm"]})

    def tree(self) -> Params:
        out: Params = dict(self.top.items())
        out["layers"] = dict(self.layers.items())
        if hasattr(self, "encoder_layers"):
            out["encoder"] = {"layers": dict(self.encoder_layers.items()),
                              **dict(self.encoder_top.items())}
        return out

    def forward(self, tokens: torch.Tensor,
                enc_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward(self.cfg, self.tree(), tokens, enc_frames=enc_frames)[0]


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _layer(lp: Params, i: int) -> Params:
    return {k: v[i] for k, v in lp.items()}


def _slot_layer(lp: Params, i: int, kind: str, j: int) -> Params:
    """Layer i's leaves under `layer_types`: the FFN and norms at i, its
    mixer's (of `kind`) at j, its slot in that kind's stack."""
    out = {}
    for name, v in lp.items():
        own = _leaf_kind(name)
        if not own:
            out[name] = v[i]
        elif own == kind:
            out[name] = v[j]
    return out


def _prefix_layer(cfg: ModelConfig, lp: Params, i: int) -> Params:
    """Layer i's leaves under `first_k_dense`: in the first layers the dense
    FFN's, as "w_gate"/"w_up"/"w_down", and no MoE leaf; after them the MoE
    FFN's at i - first_k_dense; every other leaf at i."""
    n, moe = cfg.first_k_dense, _moe_leaves(cfg)
    out = {}
    for name, v in lp.items():
        if name in _DENSE_LEAVES:
            if i < n:
                out[_DENSE_LEAVES[name]] = v[i]
        elif name in moe:
            if i >= n:
                out[name] = v[i - n]
        else:
            out[name] = v[i]
    return out


def _scaled(t: torch.Tensor, m: float) -> torch.Tensor:
    """t * m, launching nothing where m is 1."""
    return t if m == 1.0 else t * m


def _scale_q(cfg: ModelConfig, q: torch.Tensor) -> torch.Tensor:
    """q scaled so that the kernels' 1/sqrt(q's head dim) makes the softmax
    scale `attention_multiplier`; q itself when that is 0 (the default)."""
    m = cfg.attention_multiplier
    return q if m == 0.0 else q * (m * q.shape[-1] ** 0.5)


def _rope_angles(cfg: ModelConfig, positions: torch.Tensor, dim: int):
    """cos, sin [..., dim // 2] of the rotary embedding: plain, or under
    YaRN (`yarn_factor` > 1) its frequencies and magnitude scale."""
    if cfg.yarn_factor == 1.0:
        return rope_angles(positions, dim, cfg.rope_theta)
    inv = yarn_inv_freq(dim, cfg.rope_theta, cfg.yarn_factor, cfg.yarn_original_max_pos,
                        cfg.yarn_beta_fast, cfg.yarn_beta_slow, device=positions.device)
    ang = positions.float()[..., None] * inv
    m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) / yarn_mscale(cfg.yarn_factor,
                                                                     cfg.yarn_mscale_all_dim)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (cos, sin) if m == 1.0 else (cos * m, sin * m)


def _project_qkv(cfg: ModelConfig, lp: Params, h: torch.Tensor, positions: torch.Tensor):
    B, S, _ = h.shape
    H, K, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = constrain(split_dim(q, -1, H, Hd), "bshd")
    k = constrain(split_dim(k, -1, K, Hd), "bshd")
    v = constrain(split_dim(v, -1, K, Hd), "bshd")
    if cfg.nope:
        return q, k, v
    cos, sin = _rope_angles(cfg, positions, Hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mla_project(cfg: ModelConfig, lp: Params, h: torch.Tensor, positions: torch.Tensor):
    """MLA's projections of h (B, S, D): q_nope (B, S, H, dn), the roped
    q_pe (B, S, H, dr), the normed latent c (B, S, r) and the roped k_pe
    (B, S, 1, dr)."""
    B, S, _ = h.shape
    H, dn, dr, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    q = (rms_norm(h @ lp["wq_a"], lp["q_norm"], cfg.norm_eps) @ lp["wq_b"]).view(B, S, H, dn + dr)
    kv_a = h @ lp["wkv_a"]
    c = rms_norm(kv_a[..., :r], lp["kv_norm"], cfg.norm_eps)
    cos, sin = _rope_angles(cfg, positions, dr)
    return (q[..., :dn], apply_rope(q[..., dn:], cos, sin), c,
            apply_rope(kv_a[..., None, r:], cos, sin))


def _mla_block(cfg: ModelConfig, lp: Params, h: torch.Tensor, positions: torch.Tensor):
    """MLA over the whole sequence in the expanded form, in a `model.mla`
    span: (output (B, S, D), the layer's cache "k" = k_pe (B, S, 1, dr) and
    "v" = c (B, S, 1, r)). The attention is the model's `prefill_attention`
    at q/k head dim dn + dr and v head dim dv."""
    with _spans.span("model.mla"):
        B, S, _ = h.shape
        H, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        q_nope, q_pe, c, k_pe = _mla_project(cfg, lp, h, positions)
        kv = (c @ lp["wkv_b"]).view(B, S, H, dn + dv)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([kv[..., :dn], k_pe.expand(B, S, H, dr)], dim=-1)
        a = prefill_attention(_scale_q(cfg, q), k, kv[..., dn:], window=cfg.sliding_window,
                              use_pallas=cfg.use_pallas)
        return _merge_heads(a) @ lp["wo"], {"k": k_pe, "v": c[:, :, None]}


def _mla_step(cfg: ModelConfig, lp: Params, h: torch.Tensor, cache: Dict[str, torch.Tensor],
              i: int, pos: torch.Tensor) -> torch.Tensor:
    """MLA's decode step in the absorbed form, in a `model.mla` span: the
    step's c and k_pe written into layer i's cache at `pos`, q_nope taken
    into the latent by W_kvb's key part, attention over the latent cache
    (`attend_latent`), the latent output out through W_kvb's value part
    and W_o."""
    with _spans.span("model.mla"):
        B = h.shape[0]
        H, dn, dv, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
        q_nope, q_pe, c, k_pe = _mla_project(cfg, lp, h, pos.reshape(1))
        pe_cache, c_cache, valid = cache_update(cache["k"][i], cache["v"][i], k_pe, c[:, :, None],
                                                pos, window=cfg.sliding_window)
        w = lp["wkv_b"].view(r, H, dn + dv)
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w[..., :dn])
        scale = cfg.attention_multiplier or (dn + cfg.qk_rope_head_dim) ** -0.5
        o = attend_latent(q_lat, q_pe, c_cache, pe_cache, valid, scale)
        o = torch.einsum("bshr,rhd->bshd", o, w[..., dn:])
        return o.reshape(B, 1, H * dv) @ lp["wo"]


def _ring_cache(k: torch.Tensor, window: int) -> torch.Tensor:
    """Arrange the last `window` keys/values into decode ring-buffer order:
    absolute position p lands at slot p % window. k: (B, S, K, Hd)."""
    S = k.shape[1]
    if S <= window:
        out = k.new_zeros((k.shape[0], window) + k.shape[2:])
        out[:, :S] = k
        return out
    slots = torch.arange(S - window, S, device=k.device) % window
    out = k.new_zeros((k.shape[0], window) + k.shape[2:])
    out[:, slots] = k[:, S - window:]
    return out


def _merge_heads(a: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Hd) -> (B, S, H*Hd). A DTensor's gradient comes back in this
    layout, so the backward split into heads never meets a shard it cannot
    split."""
    return hold_layout(a.reshape(a.shape[0], a.shape[1], -1))


def _project_q(cfg: ModelConfig, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return split_dim(h @ w, -1, cfg.num_heads, cfg.resolved_head_dim)


def _project_kv_cross(cfg: ModelConfig, lp: Params, enc_out: torch.Tensor):
    """The decoder layer's cross-attention K/V over the encoder's output:
    (B, S_enc, K, Hd) each, no RoPE."""
    K, Hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return split_dim(enc_out @ lp["xwk"], -1, K, Hd), split_dim(enc_out @ lp["xwv"], -1, K, Hd)


def _cross_block(cfg: ModelConfig, lp: Params, x: torch.Tensor, kx: torch.Tensor,
                 vx: torch.Tensor) -> torch.Tensor:
    """x + cross-attention of the normed x over the encoder's K/V."""
    hx = rms_norm(x, lp["lnx"], cfg.norm_eps)
    a = attend_cross(_project_q(cfg, lp["xwq"], hx), kx, vx)
    return x + _merge_heads(a) @ lp["xwo"]


def _ffn_block(cfg: ModelConfig, lp: Params, x: torch.Tensor, moe=moe_ffn_ep
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x + the FFN of the normed x (SwiGLU, or the MoE FFN `moe` over the
    B*S tokens, `moe_ffn_dropless` for a dropless MoE, plus the shared
    expert, in a `model.moe` span), times `residual_multiplier`; returns the
    MoE aux losses ({} for a dense FFN)."""
    # the residual stream's layout before the FFN reads it (a site of the
    # port's own: DTensor would otherwise carry the attention output's partial
    # sum into the FFN and replicate its products over `model`)
    x = constrain(x, "bsd")
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.num_experts == 0 or "router" not in lp:  # a dense model, or a dense-prefix layer
        return x + _scaled(swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"]),
                           cfg.residual_multiplier), {}
    if cfg.dropless:
        moe = moe_ffn_dropless
    with _spans.span("model.moe") as sp:
        tokens = h2.reshape(-1, h2.shape[-1])
        y, aux = moe(cfg, lp, tokens)
        y = y.reshape(h2.shape)
        if cfg.shared_d_ff:
            y = y + swiglu(h2, lp["shared_gate"], lp["shared_up"], lp["shared_down"])
        if sp is not None:
            pairs = tokens.shape[0] * cfg.experts_per_token
            sp.counters["routed_pairs"] = pairs
            # a share's count is read on the host only here, with a recorder
            # attached, and not while a CUDA graph captures the step
            held = aux.get("held_pairs", pairs)
            if not (isinstance(held, torch.Tensor) and held.is_cuda
                    and torch.cuda.is_current_stream_capturing()):
                sp.counters["held_pairs"] = int(held)
    return x + _scaled(y, cfg.residual_multiplier), aux


def _mixer_kind(cfg: ModelConfig, kind: str) -> str:
    """A layer's mixer: `kind` under `layer_types`, else as `arch_type`
    says ("attention" for a hybrid, whose SSM heads run beside it), "mla"
    for latent attention."""
    if kind:
        return kind
    return "mamba" if cfg.arch_type == "ssm" else "mla" if cfg.mla else "attention"


def _decoder_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor,
                   enc_out: Optional[torch.Tensor] = None, collect_cache: bool = False,
                   kind: str = ""
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One layer over the whole sequence; returns (x, MoE aux losses, this
    layer's decode cache, empty unless `collect_cache`). `kind` is the
    layer's mixer under `layer_types`."""
    cache: Dict[str, torch.Tensor] = {}
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    mixer = _mixer_kind(cfg, kind)
    if mixer == "mamba":
        mixed, st, conv_tail = mamba2_mixer(cfg, lp, h)
        if collect_cache:
            cache = {"ssm_state": st.float(), "conv_buf": conv_tail}
    elif mixer == "mla":
        mixed, latent = _mla_block(cfg, lp, h, positions)
        if collect_cache:
            cache = latent
    else:
        q, k, v = _project_qkv(cfg, lp, h, positions)
        a = prefill_attention(_scale_q(cfg, q), k, v, window=cfg.sliding_window,
                              use_pallas=cfg.use_pallas)
        a = constrain(a, "bshd")
        mixed = _merge_heads(a) @ lp["wo"]
        if collect_cache:
            if cfg.sliding_window > 0:
                k, v = _ring_cache(k, cfg.sliding_window), _ring_cache(v, cfg.sliding_window)
            # the decode-cache layout here, so the cache's length sharding does
            # not reach back into attention
            cache.update({"k": constrain(k, "cache_kv"), "v": constrain(v, "cache_kv")})
        if cfg.hybrid:
            y, st, conv_tail = mamba2_mixer(cfg, lp, h)
            if collect_cache:
                cache.update({"ssm_state": st.float(), "conv_buf": conv_tail})
            mixed = 0.5 * (mixed + y)  # Hymba-style parallel head fusion
    x = x + _scaled(mixed, cfg.residual_multiplier)
    if cfg.arch_type == "ssm":  # a Mamba2 block is its mixer alone
        return x, {}, cache
    if cfg.is_encdec and enc_out is not None:
        kx, vx = _project_kv_cross(cfg, lp, enc_out)
        x = _cross_block(cfg, lp, x, kx, vx)
        if collect_cache:
            cache.update({"enc_k": constrain(kx, "cache_kv"), "enc_v": constrain(vx, "cache_kv")})
    x, aux = _ffn_block(cfg, lp, x)
    return constrain(x, "bsd"), aux, cache


def _layers(cfg: ModelConfig, lp: Params):
    """(layer params, kind, slot) of each layer in order: under
    `layer_types` its mixer's kind and its place in that kind's stack (and
    cache), else "" and the layer's index."""
    if cfg.first_k_dense:
        return ((_prefix_layer(cfg, lp, i), "", i) for i in range(cfg.num_layers))
    if not cfg.layer_types:
        return ((_layer(lp, i), "", i) for i in range(cfg.num_layers))
    return ((_slot_layer(lp, i, kind, j), kind, j)
            for i, (kind, j) in enumerate(cfg.layer_slots()))


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over precomputed frame embeddings (B, S, D):
    RoPE'd self-attention without a mask through the plain path (the
    reference's `attend_full(causal=False)`), then SwiGLU."""
    enc = params["encoder"]
    x = frames
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.encoder_layers):
        lp = _layer(enc["layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, lp, h, positions)
        a = attend_full(q, k, v, causal=False)
        x = x + _merge_heads(a) @ lp["wo"]
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"])
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _encoder_output(cfg: ModelConfig, params: Params,
                    enc_frames: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if not cfg.is_encdec:
        return None
    if enc_frames is None:
        raise ValueError(f"{cfg.name}: the enc-dec family needs enc_frames (B, S_enc, D)")
    return encode(cfg, params, enc_frames)


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings (B, S, D), in the residual stream's layout. A
    DTensor table is first gathered over every axis but its vocabulary's
    (FSDP's gather), so the lookup is vocab-parallel: each rank looks its
    tokens up in its rows, and the residual layout sums the ranks."""
    table = params["embed"]
    if isinstance(table, DTensor):
        table = table.redistribute(table.device_mesh, [p if p.is_shard(0) else Replicate()
                                                       for p in table.placements])
    return constrain(F.embedding(tokens.long(), table), "bsd")


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params.get("lm_head")
    if head is None:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"]).float()
    else:
        logits = (x @ head).float()
    return logits if cfg.logits_scaling == 1.0 else logits / cfg.logits_scaling


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            enc_frames: Optional[torch.Tensor] = None, remat: Optional[bool] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal forward. tokens: (B, S) int -> logits (B, S, V) fp32 + aux:
    the MoE aux losses summed over layers and divided by max(L, 1) (zero
    for families without experts). enc_frames (B, S_enc, D) for enc-dec.

    `remat` (None: `cfg.remat == "full"`) checkpoints each decoder layer
    under autograd, in place of the reference's `jax.checkpoint`: the
    backward pass recomputes the layer from its input, and its aux losses
    come out of the checkpoint as outputs. The stacked layer leaves are
    unbound once, so each leaf's gradient is one stack of L slices."""
    B, S = tokens.shape
    x = _scaled(_embed(params, tokens), cfg.embedding_multiplier)
    positions = torch.arange(S, device=x.device)
    enc_out = _encoder_output(cfg, params, enc_frames)
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    zl = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = functools.partial(_decoder_layer, cfg)
    if (cfg.remat == "full" if remat is None else remat) and torch.is_grad_enabled():
        layer = functools.partial(checkpoint, layer, use_reentrant=False)
    lp = {k: v.unbind(0) for k, v in params["layers"].items()}
    for p, kind, _ in _layers(cfg, lp):
        x, aux, _ = layer(p, x, positions, enc_out, False, kind)
        if aux:
            lb, zl = lb + aux["lb_loss"], zl + aux["z_loss"]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    denom = max(cfg.num_layers, 1)
    return constrain(_logits(cfg, params, x), "logits"), {"lb_loss": lb / denom,
                                                     "z_loss": zl / denom}


def _map_leaves(fn, tree: Params) -> Params:
    return {k: _map_leaves(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss on `batch` ({"tokens", "targets"} (B, S) int, and
    "enc_frames" for enc-dec): mean token CE, plus 0.01 lb_loss + 0.001
    z_loss in the MoE family. Returns (loss, {"ce", "lb_loss", "z_loss"}).
    Raises ValueError for `cfg.use_pallas`: the hand-written kernels have
    no backward pass, as the reference's Pallas kernels have none. On
    DTensor parameters each gradient is brought to its parameter's layout
    (reduced over the ranks that hold partial sums of it), as the
    reference's train step fixes its gradients' shardings."""
    if cfg.use_pallas:
        raise ValueError(f"{cfg.name}: training takes the plain path (use_pallas=False); "
                         "the hand-written kernels have no backward pass")
    params = _map_leaves(hold_layout, params)
    logits, aux = forward(cfg, params, batch["tokens"], enc_frames=batch.get("enc_frames"))
    ce = cross_entropy(logits, batch["targets"])
    loss = ce
    if cfg.num_experts > 0:
        loss = loss + 0.01 * aux["lb_loss"] + 0.001 * aux["z_loss"]
    return loss, {"ce": ce, **aux}


def prefill_forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                    enc_frames: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Serving prefill: one parallel pass over the prompt that RETURNS the
    decode cache -- the PD-disaggregation elephant flow. Returns (last-token
    logits (B, V) fp32, cache): per-layer "k", "v" (L, B, S or window, K,
    Hd), in ring order under a sliding window, for attention layers;
    "ssm_state" (L, B, nheads, headdim, N) fp32 and "conv_buf" (L, B,
    conv-1, conv_dim) for Mamba2 layers; "enc_k", "enc_v" (L, B, S_enc,
    K, Hd), the cross-attention K/V over the encoder's output, for
    enc-dec (which needs enc_frames)."""
    with _spans.span("model.prefill") as sp:
        logits, cache = _prefill_forward(cfg, params, tokens, enc_frames)
        if sp is not None:
            _cache_counters(sp.counters, cache)
        return logits, cache


def _cache_counters(c: Dict[str, int], cache: Dict[str, torch.Tensor]) -> None:
    """`model.prefill`'s counters, from shapes: the bytes of the cache's
    fixed state ("ssm_state", "conv_buf") and of its per-token K/V."""
    nbytes = {name: t.numel() * t.element_size() for name, t in cache.items()}
    c["cache_state_bytes"] = nbytes.get("ssm_state", 0) + nbytes.get("conv_buf", 0)
    c["cache_kv_bytes"] = nbytes.get("k", 0) + nbytes.get("v", 0)


def _prefill_forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                     enc_frames: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, S = tokens.shape
    x = _scaled(_embed(params, tokens), cfg.embedding_multiplier)
    positions = torch.arange(S, device=x.device)
    enc_out = _encoder_output(cfg, params, enc_frames)
    caches = []
    for p, kind, _ in _layers(cfg, params["layers"]):
        x, _, cache = _decoder_layer(cfg, p, x, positions, enc_out, collect_cache=True,
                                     kind=kind)
        caches.append(cache)
    x_last = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    names = dict.fromkeys(name for c in caches for name in c)
    stacked = {name: torch.stack([c[name] for c in caches if name in c]) for name in names}
    return constrain(_logits(cfg, params, x_last), "logits")[:, 0], stacked


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def _cache_struct(cfg: ModelConfig, batch: int, max_len: int, enc_len: int, dtype
                  ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window > 0 else max_len
    La, Lm = L, L
    if cfg.layer_types:
        La, Lm = cfg.layers_of("attention"), cfg.layers_of("mamba")
    s: Dict[str, Tuple[tuple, torch.dtype]] = {}
    if cfg.mla:
        return {"k": ((L, batch, W, 1, cfg.qk_rope_head_dim), dtype),
                "v": ((L, batch, W, 1, cfg.kv_lora_rank), dtype)}
    if cfg.arch_type != "ssm" and La:
        s["k"] = s["v"] = ((La, batch, W, K, Hd), dtype)
    if (cfg.arch_type == "ssm" or cfg.hybrid or cfg.layer_types) and Lm:
        di, N = cfg.ssm_d_inner, cfg.ssm_state
        s["ssm_state"] = ((Lm, batch, cfg.ssm_nheads, cfg.ssm_headdim, N), torch.float32)
        s["conv_buf"] = ((Lm, batch, cfg.ssm_conv - 1, di + 2 * N), dtype)
    if cfg.is_encdec:
        s["enc_k"] = s["enc_v"] = ((L, batch, enc_len, K, Hd), dtype)
    return s


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: DeviceLike = None, *, enc_len: int = 0) -> Dict[str, torch.Tensor]:
    """Zeroed decode caches, laid out as the reference's `init_cache`; the
    SSM state is fp32 whatever `dtype` is. enc-dec adds "enc_k"/"enc_v"
    of `enc_len` encoder positions."""
    dev = default_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=dev)
            for name, (shape, dt) in _cache_struct(cfg, batch, max_len, enc_len, dtype).items()}


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
                 dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """`init_cache`'s layout as meta tensors (no allocation), as the
    reference's ShapeDtypeStruct dict."""
    return {name: torch.empty(shape, dtype=dt, device="meta")
            for name, (shape, dt) in _cache_struct(cfg, batch, max_len, enc_len, dtype).items()}


def _mixer_step(cfg: ModelConfig, p: Params, h: torch.Tensor,
                cache: Dict[str, torch.Tensor], i: int) -> torch.Tensor:
    """Layer i's Mamba2 decode step; writes its conv buffer and state into
    `cache` in place (where the decode-step kernels ran they wrote them
    there already, and the copies move no byte)."""
    y, new_buf, new_state = mamba2_mixer_step(
        cfg, p, h, cache["conv_buf"][i], cache["ssm_state"][i])
    cache["conv_buf"][i].copy_(new_buf)
    cache["ssm_state"][i].copy_(new_state)
    return y


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for the whole (synchronized) batch: token (B, 1) at
    position `pos`. Writes the new K/V, conv buffers and SSM states into
    `cache` in place and returns (logits (B, V) fp32, cache). MoE layers
    route the B tokens with the capacity of T = B.

    `pos` is an int, or a 0-d int64 tensor on the cache's device. An int
    becomes such a tensor first: RoPE and every cache write read the
    position on the device and no host reads it, so the step can be
    captured in a CUDA graph and replayed as the tensor advances
    (`serving.greedy_decode`).

    With spans on, the `model.decode_step` span counts
    `ssm_kernel_layers`: the Mamba2 layers whose step the decode-step
    kernels took (`kernels.ssm_step`)."""
    with _spans.span("model.decode_step") as sp:
        launches = ssm_step_kernel.launches
        out = _decode_step(cfg, params, cache, token, pos)
        if sp is not None:
            sp.counters["ssm_kernel_layers"] = ssm_step_kernel.launches - launches
        return out


def _decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, torch.Tensor],
                 token: torch.Tensor, pos: Union[int, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x = _scaled(_embed(params, token), cfg.embedding_multiplier)
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), int(pos), dtype=torch.int64, device=x.device)
    positions = pos.reshape(1)
    for p, kind, i in _layers(cfg, params["layers"]):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        mixer = _mixer_kind(cfg, kind)
        if mixer == "mamba":
            mixed = _mixer_step(cfg, p, h, cache, i)
        elif mixer == "mla":
            mixed = _mla_step(cfg, p, h, cache, i, pos)
        else:
            q, k, v = _project_qkv(cfg, p, h, positions)
            k_cache, v_cache, valid = cache_update(
                cache["k"][i], cache["v"][i], k, v, pos, window=cfg.sliding_window)
            a = attend_cached(_scale_q(cfg, q), k_cache, v_cache, valid)
            mixed = _merge_heads(a) @ p["wo"]
            if cfg.hybrid:
                mixed = 0.5 * (mixed + _mixer_step(cfg, p, h, cache, i))
        x = x + _scaled(mixed, cfg.residual_multiplier)
        if cfg.arch_type == "ssm":
            continue
        if cfg.is_encdec:
            x = _cross_block(cfg, p, x, cache["enc_k"][i], cache["enc_v"][i])
        x, _ = _ffn_block(cfg, p, x, moe=moe_ffn_sorted)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return constrain(_logits(cfg, params, x), "logits")[:, 0], cache


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, max_len: int, *,
            enc_frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt token by token through `decode_step` to build a decode
    cache of width `max_len` (enc-dec: the encoder runs first and fills
    "enc_k"/"enc_v"). This replay reaches neither the flash-attention
    kernel nor the SSD-scan kernel; with `use_pallas` on a card its Mamba2
    layers take the decode-step kernels."""
    B, S = tokens.shape
    emb = params["embed"]
    enc_out = _encoder_output(cfg, params, enc_frames)
    enc_len = 0 if enc_out is None else enc_out.shape[1]
    cache = init_cache(cfg, B, max_len, dtype=emb.dtype, device=emb.device, enc_len=enc_len)
    if enc_out is not None:
        lp = params["layers"]
        for i in range(cfg.num_layers):
            kx, vx = _project_kv_cross(cfg, _layer(lp, i), enc_out)
            cache["enc_k"][i].copy_(kx)
            cache["enc_v"][i].copy_(vx)
    last = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=emb.device)
    for t in range(S):
        last, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1], t)
    return last, cache
