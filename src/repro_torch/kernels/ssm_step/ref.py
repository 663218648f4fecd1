"""Plain torch version of the Mamba2 decode-step kernels: the mixer's
recurrence from the in-projection's output to the gated norm's input, as
`models/ssm.py::mamba2_mixer_step` ran it op for op before the kernels.

The conv window in the activation dtype, `ssd_step`'s fp32 state update and
the D skip; it returns a new conv buffer and a new state, which the caller
stores into the cache. CPU tensors run it, and so does the model with
`use_pallas` off. `ssd_step` (the O(1) state update, also the step of
`models/ssm.py::ssd_recurrent_ref`) and `decay` (shared with the prefill
mixer) live here so that the models import the kernels and not the other
way round.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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


def decay(dt: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor):
    """softplus(dt + dt_bias) and A = -exp(A_log), both fp32."""
    return F.softplus(dt.float() + dt_bias.float()), -torch.exp(A_log.float())


def mamba2_step_ref(
    xBC: torch.Tensor,  # (b, conv_dim) the in-projection's x|B|C columns
    dt: torch.Tensor,  # (b, nh) its raw dt columns
    conv_buf: torch.Tensor,  # (b, k-1, conv_dim)
    state: torch.Tensor,  # (b, nh, hd, N) fp32
    conv_w: torch.Tensor,  # (k, conv_dim)
    conv_b: torch.Tensor,  # (conv_dim,)
    dt_bias: torch.Tensor,  # (nh,)
    A_log: torch.Tensor,  # (nh,)
    D: torch.Tensor,  # (nh,)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y (b, nh, hd) in xBC's dtype, conv_buf', state')."""
    b, nh, hd, N = state.shape
    di = nh * hd
    window = torch.cat([conv_buf.to(xBC.dtype), xBC[:, None, :]], dim=1)  # (b, k, c)
    conv = torch.einsum("bkc,kc->bc", window, conv_w) + conv_b
    conv = F.silu(conv)
    new_buf = window[:, 1:].to(conv_buf.dtype)
    xs = conv[:, :di].reshape(b, nh, hd)
    B = conv[:, di:di + N]
    C = conv[:, di + N:]
    dt1, A = decay(dt, dt_bias, A_log)
    a_t = dt1 * A  # (b, nh)
    x_dt = xs * dt1.to(xs.dtype)[..., None]
    state, y = ssd_step(state, x_dt, a_t, B, C)
    y = y.to(xBC.dtype) + xs * D.to(xBC.dtype)[None, :, None]
    return y, new_buf, state
