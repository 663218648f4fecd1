"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060] in torch.

Counterpart of `repro.models.ssm`, with the same cast points.
`ssd_chunked` is the chunked prefill form (quadratic intra-chunk, linear
inter-chunk recurrence) and, when `use_pallas` is set, dispatches to the
SSD-scan kernel (the Hopper kernel on CUDA tensors, its plain version on
CPU tensors); `ssd_recurrent_ref` is the step-by-step oracle; `ssd_step`
is the O(1) decode update. The depthwise causal conv is a sum of shifts
(kernel size 4), as in the reference: `F.conv1d` would go through cuDNN,
which runs float32 in TF32 by default. The reference's sharding
constraints are left out (sharding is not ported).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import rms_norm


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., T). Returns (..., T, T) with out[i, j] = sum_{k=j+1..i} a_k
    for i >= j, -inf above the diagonal."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, torch.full_like(out, float("-inf")))


def ssd_chunked(
    x: torch.Tensor,  # (b, s, h, p) -- pre-multiplied by dt
    a: torch.Tensor,  # (b, s, h)    -- dt * A (negative log-decay increments)
    B: torch.Tensor,  # (b, s, n)
    C: torch.Tensor,  # (b, s, n)
    *,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b,s,h,p), final_state (b,h,p,n)) in x's dtype. The
    inter-chunk recurrence is an eager loop, so `prev * dec + st` is never
    contracted into an fma (the reference's `/ one` guard is not needed)."""
    if use_pallas:
        from ..kernels.ssd_scan.ops import ssd_chunked as ssd_kernel

        return ssd_kernel(x, a, B, C, chunk=chunk, initial_state=initial_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        # pad with identity steps (x=0, B=0, a=0): state passes through
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        y, st = ssd_chunked(x, a, B, C, chunk=chunk, initial_state=initial_state)
        return y[:, :s], st
    c = s // chunk
    xc = x.reshape(b, c, chunk, h, p)
    ac = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (b,h,c,l)
    Bc = B.reshape(b, c, chunk, n)
    Cc = C.reshape(b, c, chunk, n)

    a_cs = torch.cumsum(ac, dim=-1)  # (b,h,c,l)
    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(segsum(ac))  # (b,h,c,l,l)
    Y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)
    # 2. per-chunk end states
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)  # (b,h,c,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)
    # 3. inter-chunk recurrence
    chunk_decay = torch.exp(a_cs[..., -1])  # (b,h,c)
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    carry = initial_state.float()
    states_f = states.float()
    prev = []
    for i in range(c):
        prev.append(carry)
        dec = chunk_decay[:, :, i][..., None, None].to(carry.dtype)
        carry = carry * dec + states_f[:, i]
    states_prev = torch.stack(prev, dim=1)  # (b,c,h,p,n)
    # 4. state -> output contribution
    state_decay_out = torch.exp(a_cs)  # (b,h,c,l)
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states_prev.to(x.dtype),
                         state_decay_out.to(x.dtype))
    y = (Y_diag + Y_off).reshape(b, s, h, p)
    return y, carry.to(x.dtype)


def ssd_recurrent_ref(
    x: torch.Tensor, a: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step oracle: h_t = exp(a_t) h_{t-1} + B_t x_t; y_t = C_t h_t.
    Returns (y, final_state) in x's dtype."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    st = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        st, y_t = ssd_step(st, x[:, t], a[:, t], B[:, t], C[:, t])
        ys.append(y_t)
    return torch.stack(ys, dim=1).to(x.dtype), st.to(x.dtype)


def ssd_step(
    state: torch.Tensor,  # (b, h, p, n) fp32
    x_t: torch.Tensor,  # (b, h, p) -- pre-multiplied by dt
    a_t: torch.Tensor,  # (b, h)    -- dt * A
    B_t: torch.Tensor,  # (b, n)
    C_t: torch.Tensor,  # (b, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    state = state * torch.exp(a_t.float())[..., None, None]
    state = state + torch.einsum("bhp,bn->bhpn", x_t.float(), B_t.float())
    y = torch.einsum("bhpn,bn->bhp", state, C_t.float())
    return state, y


# ---------------------------------------------------------------------------
# Full Mamba2 mixer (in_proj -> conv -> SSD -> gate -> norm -> out_proj)
# ---------------------------------------------------------------------------

def mixer_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    di, N, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * N
    return {
        "ssm_in": (cfg.d_model, 2 * di + 2 * N + nh),
        "ssm_conv_w": (cfg.ssm_conv, conv_dim),
        "ssm_conv_b": (conv_dim,),
        "ssm_dt_bias": (nh,),
        "ssm_A_log": (nh,),
        "ssm_D": (nh,),
        "ssm_norm": (di,),
        "ssm_out": (di, cfg.d_model),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, N, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    if dt.shape[-1] != nh:
        raise ValueError(f"projection width gives {dt.shape[-1]} dt heads, expected {nh}")
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as a sum of shifts. xBC: (b, s, c); w: (k, c)."""
    k = w.shape[0]
    out = torch.zeros_like(xBC)
    for i in range(k):
        shift = k - 1 - i
        shifted = F.pad(xBC, (0, 0, shift, 0))[:, :xBC.shape[1]]
        out = out + shifted * w[i]
    return F.silu(out + b)


def _decay(dt: torch.Tensor, p: Dict[str, torch.Tensor]):
    """softplus(dt + dt_bias) and A = -exp(A_log), both fp32."""
    return F.softplus(dt.float() + p["ssm_dt_bias"].float()), -torch.exp(p["ssm_A_log"].float())


def mamba2_mixer(
    cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
    *, initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill mixer. x: (b, s, D) -> (y (b, s, D), final_state (x's dtype),
    conv_tail (b, conv-1, conv_dim) -- the decode conv buffer)."""
    b, s, _ = x.shape
    di, N, nh, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    zxbcdt = x @ p["ssm_in"]
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    tail = cfg.ssm_conv - 1
    pad_raw = F.pad(xBC, (0, 0, tail, 0))
    conv_tail = pad_raw[:, pad_raw.shape[1] - tail:, :]
    xBC = _causal_conv(xBC, p["ssm_conv_w"], p["ssm_conv_b"])
    xs = xBC[..., :di].reshape(b, s, nh, hd)
    B = xBC[..., di:di + N]
    C = xBC[..., di + N:]
    dt, A = _decay(dt, p)
    a = (dt * A).to(x.dtype)  # (b,s,nh)
    x_dt = xs * dt.to(x.dtype)[..., None]
    y, final_state = ssd_chunked(x_dt, a, B, C, chunk=cfg.ssm_chunk,
                                 initial_state=initial_state, use_pallas=cfg.use_pallas)
    y = y + xs * p["ssm_D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, di)
    y = rms_norm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    return y @ p["ssm_out"], final_state, conv_tail


def mamba2_mixer_step(
    cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
    conv_buf: torch.Tensor, state: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode mixer. x: (b, 1, D); conv_buf: (b, k-1, conv_dim);
    state: (b, nh, hd, N) fp32. Returns (y (b,1,D), conv_buf', state')."""
    b = x.shape[0]
    di, N, nh, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    zxbcdt = x @ p["ssm_in"]
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = xBC[:, 0]  # (b, conv_dim)
    window = torch.cat([conv_buf.to(xBC.dtype), xBC[:, None, :]], dim=1)  # (b, k, c)
    conv = torch.einsum("bkc,kc->bc", window, p["ssm_conv_w"]) + p["ssm_conv_b"]
    conv = F.silu(conv)
    new_buf = window[:, 1:].to(conv_buf.dtype)
    xs = conv[:, :di].reshape(b, nh, hd)
    B = conv[:, di:di + N]
    C = conv[:, di + N:]
    dt1, A = _decay(dt[:, 0], p)
    a_t = dt1 * A  # (b, nh)
    x_dt = xs * dt1.to(xs.dtype)[..., None]
    state, y = ssd_step(state, x_dt, a_t, B, C)
    y = y.to(x.dtype) + xs * p["ssm_D"].to(x.dtype)[None, :, None]
    y = y.reshape(b, 1, di)
    y = rms_norm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    return y @ p["ssm_out"], new_buf, state
