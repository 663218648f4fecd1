"""Decoder-only LM (dense, vlm, ssm and hybrid families) in torch.

Counterpart of `repro.models.model`. Parameters keep the reference's
stacked-dict layout, `{"embed", "final_norm", "layers": {name: (L, ...)}}`
(plus "lm_head" when embeddings are untied), so `params_from_numpy` maps
the reference's pytree onto it leaf for leaf. The reference's `lax.scan`
over layers is a Python loop over the layer axis. Entry points:

  param_shapes / init_params      parameters
  forward                         causal LM forward
  prefill_forward                 serving prefill, returns the decode cache
  init_cache / decode_step        decode caches and the single-token step
  prefill                         replay prefill through decode_step
  DecoderLM                       an nn.Module holding the parameters

SSM layers are Mamba2 mixers (`ssm.py`); hybrid layers run attention and
the mixer in parallel from the same input and average them. MoE and
enc-dec configs raise NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import DeviceLike, default_device
from .attention import attend_cached, cache_update, prefill_attention
from .common import apply_rope, dense_init, embed_init, rms_norm, rope_angles, swiglu
from .ssm import mamba2_mixer, mamba2_mixer_step, mixer_param_shapes

Params = Dict[str, Any]

_NOT_PORTED = {
    "moe": "ROADMAP queue 1 (models/moe.py)",
    "encdec": "ROADMAP queue 1 (enc-dec cross-attention)",
}


def _check_family(cfg: ModelConfig) -> None:
    """The dense, vlm, ssm and hybrid families are ported."""
    if cfg.num_experts > 0:
        fam = "moe"
    elif cfg.is_encdec:
        fam = "encdec"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: the {fam} family is not ported to repro_torch yet; "
        f"see {_NOT_PORTED[fam]}")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    D, H, K, Hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s: Dict[str, tuple] = {"ln1": (D,)}
    if cfg.arch_type == "ssm":
        s.update(mixer_param_shapes(cfg))
        return s
    s.update({
        "wq": (D, H * Hd),
        "wk": (D, K * Hd),
        "wv": (D, K * Hd),
        "wo": (H * Hd, D),
    })
    if cfg.qkv_bias:
        s.update({"bq": (H * Hd,), "bk": (K * Hd,), "bv": (K * Hd,)})
    if cfg.hybrid:
        s.update(mixer_param_shapes(cfg))
    s["ln2"] = (D,)
    s.update({"w_gate": (D, cfg.d_ff), "w_up": (D, cfg.d_ff), "w_down": (cfg.d_ff, D)})
    return s


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    _check_family(cfg)
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    out: Dict[str, Any] = {
        "embed": (V, D),
        "final_norm": (D,),
        "layers": {k: (L,) + v for k, v in _layer_shapes(cfg).items()},
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = (D, V)
    return out


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=torch.bfloat16,
                device: DeviceLike = None) -> Params:
    """Random parameters on `device` (CUDA unless the caller asks for the
    CPU): matrices Normal(0, fan_in**-0.5), embeddings Normal(0, 0.02),
    norms ones, biases zeros, and the reference's Mamba2 values for the SSM
    leaves (A_log = log(1..nheads), D = 1, dt_bias = -2, conv weights
    Normal(0, 0.1), conv bias 0). `gen` must live on that device. Drawn leaf by
    leaf in sorted-key order; a torch generator does not give the
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

    params: Params = {}
    for name in sorted(shapes):
        if name == "layers":
            params[name] = {k: mk(k, s) for k, s in sorted(shapes[name].items())}
        else:
            params[name] = mk(name, shapes[name])
    return params


class DecoderLM(nn.Module):
    """The parameters as an `nn.Module` (frozen: the port has no training
    yet). `tree()` hands the functional entry points their dict."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        top = {k: v for k, v in params.items() if k != "layers"}
        self.top = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in top.items()})
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in params["layers"].items()})

    def tree(self) -> Params:
        out: Params = dict(self.top.items())
        out["layers"] = dict(self.layers.items())
        return out

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.tree(), tokens)[0]


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


def _decoder_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor,
                   collect_cache: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer over the whole sequence; returns (x, this layer's decode
    cache, empty unless `collect_cache`)."""
    cache: Dict[str, torch.Tensor] = {}
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.arch_type == "ssm":
        y, st, conv_tail = mamba2_mixer(cfg, lp, h)
        if collect_cache:
            cache = {"ssm_state": st.float(), "conv_buf": conv_tail}
        return x + y, cache
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
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"]), cache


def _logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params.get("lm_head")
    if head is None:
        return torch.einsum("bsd,vd->bsv", x, params["embed"]).float()
    return (x @ head).float()


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal forward. tokens: (B, S) int -> logits (B, S, V) fp32 + aux
    (the MoE aux losses, zero for the ported families)."""
    _check_family(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)
    lp = params["layers"]
    for i in range(cfg.num_layers):
        x, _ = _decoder_layer(cfg, _layer(lp, i), x, positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, x), {"lb_loss": zero, "z_loss": zero}


def prefill_forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Serving prefill: one parallel pass over the prompt that RETURNS the
    decode cache -- the PD-disaggregation elephant flow. Returns (last-token
    logits (B, V) fp32, cache): per-layer "k", "v" (L, B, S or window, K,
    Hd), in ring order under a sliding window, for attention layers;
    "ssm_state" (L, B, nheads, headdim, N) fp32 and "conv_buf" (L, B,
    conv-1, conv_dim) for Mamba2 layers."""
    _check_family(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)
    lp = params["layers"]
    caches = []
    for i in range(cfg.num_layers):
        x, cache = _decoder_layer(cfg, _layer(lp, i), x, positions, collect_cache=True)
        caches.append(cache)
    x_last = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    stacked = {name: torch.stack([c[name] for c in caches]) for name in caches[0]}
    return _logits(params, x_last)[:, 0], stacked


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed decode caches, laid out as the reference's `init_cache`; the
    SSM state is fp32 whatever `dtype` is."""
    _check_family(cfg)
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
    `cache` in place and returns (logits (B, V) fp32, cache)."""
    _check_family(cfg)
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
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + swiglu(h2, p["w_gate"], p["w_up"], p["w_down"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x)[:, 0], cache


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, max_len: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt token by token through `decode_step` to build a decode
    cache of width `max_len`. This replay reaches neither the
    flash-attention kernel nor the SSD-scan kernel."""
    B, S = tokens.shape
    emb = params["embed"]
    cache = init_cache(cfg, B, max_len, dtype=emb.dtype, device=emb.device)
    last = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=emb.device)
    for t in range(S):
        last, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1], t)
    return last, cache
