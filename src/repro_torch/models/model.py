"""One model definition for every family of the reference, in torch.

Counterpart of `repro.models.model`, parameterized by ModelConfig:
  dense / vlm      -> GQA attention + SwiGLU FFN decoder
  moe              -> GQA attention + top-k expert FFN (sorted dispatch)
  ssm              -> Mamba2 SSD mixer blocks (attention-free)
  hybrid           -> parallel attention + SSM heads per layer + FFN
  audio (enc-dec)  -> bidirectional encoder over frame embeddings + causal
                      decoder with cross-attention

Parameters keep the reference's stacked-dict layout, `{"embed",
"final_norm", "layers": {name: (L, ...)}}` (plus "lm_head" when embeddings
are untied, and "encoder": {"layers", "final_norm"} for enc-dec), so
`params_from_numpy` maps the reference's pytree onto it leaf for leaf. The
reference's `lax.scan` over layers is a Python loop over the layer axis.
Entry points:

  param_shapes / init_params      parameters
  forward                         causal LM forward (+ MoE aux losses)
  prefill_forward                 serving prefill, returns the decode cache
  init_cache / decode_step        decode caches and the single-token step
  prefill                         replay prefill through decode_step
  encode                          audio encoder (enc-dec only)
  DecoderLM                       an nn.Module holding the parameters

SSM layers are Mamba2 mixers (`ssm.py`); hybrid layers run attention and
the mixer in parallel from the same input and average them. MoE layers
call `moe.moe_ffn_sorted` where the reference calls `moe_ffn_ep`, which
is `moe_ffn_sorted` without a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import DeviceLike, default_device
from .attention import attend_cached, attend_cross, attend_full, cache_update, prefill_attention
from .common import apply_rope, dense_init, embed_init, rms_norm, rope_angles, swiglu
from .moe import moe_ffn_sorted, moe_param_shapes
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


def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    D = cfg.d_model
    s: Dict[str, tuple] = {"ln1": (D,)}
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


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    out: Dict[str, Any] = {
        "embed": (V, D),
        "final_norm": (D,),
        "layers": {k: (L,) + v for k, v in _layer_shapes(cfg).items()},
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
        if name.startswith("ln") or name in ("final_norm", "ssm_norm", "ssm_D"):
            return torch.ones(shape, dtype=dtype, device=dev)
        if name in ("bq", "bk", "bv", "ssm_conv_b"):
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


def _frozen(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})


class DecoderLM(nn.Module):
    """The parameters as an `nn.Module` (frozen: the port has no training
    yet). `tree()` hands the functional entry points their dict."""

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


def _project_qkv(cfg: ModelConfig, lp: Params, h: torch.Tensor, positions: torch.Tensor):
    B, S, _ = h.shape
    H, K, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, S, H, Hd)
    k = k.reshape(B, S, K, Hd)
    v = v.reshape(B, S, K, Hd)
    cos, sin = rope_angles(positions, Hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


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


def _project_q(cfg: ModelConfig, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    B, S, _ = h.shape
    return (h @ w).reshape(B, S, cfg.num_heads, cfg.resolved_head_dim)


def _project_kv_cross(cfg: ModelConfig, lp: Params, enc_out: torch.Tensor):
    """The decoder layer's cross-attention K/V over the encoder's output:
    (B, S_enc, K, Hd) each, no RoPE."""
    B, Se, _ = enc_out.shape
    K, Hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return ((enc_out @ lp["xwk"]).reshape(B, Se, K, Hd),
            (enc_out @ lp["xwv"]).reshape(B, Se, K, Hd))


def _cross_block(cfg: ModelConfig, lp: Params, x: torch.Tensor, kx: torch.Tensor,
                 vx: torch.Tensor) -> torch.Tensor:
    """x + cross-attention of the normed x over the encoder's K/V."""
    hx = rms_norm(x, lp["lnx"], cfg.norm_eps)
    a = attend_cross(_project_q(cfg, lp["xwq"], hx), kx, vx)
    return x + a.reshape(x.shape[0], x.shape[1], -1) @ lp["xwo"]


def _ffn_block(cfg: ModelConfig, lp: Params, x: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x + the FFN of the normed x (SwiGLU, or the MoE FFN over the B*S
    tokens); returns the MoE aux losses ({} for a dense FFN)."""
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.num_experts == 0:
        return x + swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"]), {}
    y, aux = moe_ffn_sorted(cfg, lp, h2.reshape(-1, h2.shape[-1]))
    return x + y.reshape(h2.shape), aux


def _decoder_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor,
                   enc_out: Optional[torch.Tensor] = None, collect_cache: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One layer over the whole sequence; returns (x, MoE aux losses, this
    layer's decode cache, empty unless `collect_cache`)."""
    cache: Dict[str, torch.Tensor] = {}
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.arch_type == "ssm":
        y, st, conv_tail = mamba2_mixer(cfg, lp, h)
        if collect_cache:
            cache = {"ssm_state": st.float(), "conv_buf": conv_tail}
        return x + y, {}, cache
    q, k, v = _project_qkv(cfg, lp, h, positions)
    a = prefill_attention(q, k, v, window=cfg.sliding_window, use_pallas=cfg.use_pallas)
    attn = a.reshape(a.shape[0], a.shape[1], -1) @ lp["wo"]
    if collect_cache:
        if cfg.sliding_window > 0:
            k, v = _ring_cache(k, cfg.sliding_window), _ring_cache(v, cfg.sliding_window)
        cache.update({"k": k, "v": v})
    mixed = attn
    if cfg.hybrid:
        y, st, conv_tail = mamba2_mixer(cfg, lp, h)
        if collect_cache:
            cache.update({"ssm_state": st.float(), "conv_buf": conv_tail})
        mixed = 0.5 * (attn + y)  # Hymba-style parallel head fusion
    x = x + mixed
    if cfg.is_encdec and enc_out is not None:
        kx, vx = _project_kv_cross(cfg, lp, enc_out)
        x = _cross_block(cfg, lp, x, kx, vx)
        if collect_cache:
            cache.update({"enc_k": kx, "enc_v": vx})
    x, aux = _ffn_block(cfg, lp, x)
    return x, aux, cache


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
        x = x + a.reshape(x.shape[0], x.shape[1], -1) @ lp["wo"]
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


def _logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params.get("lm_head")
    if head is None:
        return torch.einsum("bsd,vd->bsv", x, params["embed"]).float()
    return (x @ head).float()


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            enc_frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal forward. tokens: (B, S) int -> logits (B, S, V) fp32 + aux:
    the MoE aux losses summed over layers and divided by max(L, 1) (zero
    for families without experts). enc_frames (B, S_enc, D) for enc-dec."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)
    enc_out = _encoder_output(cfg, params, enc_frames)
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    zl = torch.zeros((), dtype=torch.float32, device=x.device)
    lp = params["layers"]
    for i in range(cfg.num_layers):
        x, aux, _ = _decoder_layer(cfg, _layer(lp, i), x, positions, enc_out)
        if aux:
            lb, zl = lb + aux["lb_loss"], zl + aux["z_loss"]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    denom = max(cfg.num_layers, 1)
    return _logits(params, x), {"lb_loss": lb / denom, "z_loss": zl / denom}


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
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)
    enc_out = _encoder_output(cfg, params, enc_frames)
    lp = params["layers"]
    caches = []
    for i in range(cfg.num_layers):
        x, _, cache = _decoder_layer(cfg, _layer(lp, i), x, positions, enc_out,
                                     collect_cache=True)
        caches.append(cache)
    x_last = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    stacked = {name: torch.stack([c[name] for c in caches]) for name in caches[0]}
    return _logits(params, x_last)[:, 0], stacked


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: DeviceLike = None, *, enc_len: int = 0) -> Dict[str, torch.Tensor]:
    """Zeroed decode caches, laid out as the reference's `init_cache`; the
    SSM state is fp32 whatever `dtype` is. enc-dec adds "enc_k"/"enc_v"
    of `enc_len` encoder positions."""
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window > 0 else max_len
    dev = default_device(device)
    cache: Dict[str, torch.Tensor] = {}
    if cfg.arch_type != "ssm":
        for name in ("k", "v"):
            cache[name] = torch.zeros((L, batch, W, K, Hd), dtype=dtype, device=dev)
    if cfg.arch_type == "ssm" or cfg.hybrid:
        di, N = cfg.ssm_d_inner, cfg.ssm_state
        cache["ssm_state"] = torch.zeros((L, batch, cfg.ssm_nheads, cfg.ssm_headdim, N),
                                         dtype=torch.float32, device=dev)
        cache["conv_buf"] = torch.zeros((L, batch, cfg.ssm_conv - 1, di + 2 * N),
                                        dtype=dtype, device=dev)
    if cfg.is_encdec:
        for name in ("enc_k", "enc_v"):
            cache[name] = torch.zeros((L, batch, enc_len, K, Hd), dtype=dtype, device=dev)
    return cache


def _mixer_step(cfg: ModelConfig, p: Params, h: torch.Tensor,
                cache: Dict[str, torch.Tensor], i: int) -> torch.Tensor:
    """Layer i's Mamba2 decode step; writes its conv buffer and state into
    `cache` in place."""
    y, new_buf, new_state = mamba2_mixer_step(
        cfg, p, h, cache["conv_buf"][i], cache["ssm_state"][i])
    cache["conv_buf"][i].copy_(new_buf)
    cache["ssm_state"][i].copy_(new_state)
    return y


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for the whole (synchronized) batch: token (B, 1) at
    position `pos`. Writes the new K/V, conv buffers and SSM states into
    `cache` in place and returns (logits (B, V) fp32, cache). MoE layers
    route the B tokens with the capacity of T = B."""
    pos = int(pos)
    x = params["embed"][token.long()]
    positions = torch.full((1,), pos, device=x.device)
    lp = params["layers"]
    for i in range(cfg.num_layers):
        p = _layer(lp, i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.arch_type == "ssm":
            x = x + _mixer_step(cfg, p, h, cache, i)
            continue
        q, k, v = _project_qkv(cfg, p, h, positions)
        k_cache, v_cache, valid = cache_update(
            cache["k"][i], cache["v"][i], k, v, pos, window=cfg.sliding_window)
        a = attend_cached(q, k_cache, v_cache, valid)
        mixed = a.reshape(x.shape[0], 1, -1) @ p["wo"]
        if cfg.hybrid:
            mixed = 0.5 * (mixed + _mixer_step(cfg, p, h, cache, i))
        x = x + mixed
        if cfg.is_encdec:
            x = _cross_block(cfg, p, x, cache["enc_k"][i], cache["enc_v"][i])
        x, _ = _ffn_block(cfg, p, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x)[:, 0], cache


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, max_len: int, *,
            enc_frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt token by token through `decode_step` to build a decode
    cache of width `max_len` (enc-dec: the encoder runs first and fills
    "enc_k"/"enc_v"). This replay reaches neither the flash-attention
    kernel nor the SSD-scan kernel."""
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
