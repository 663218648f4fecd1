"""Shared model components: norms, RoPE, initializers, SwiGLU.

Torch counterparts of `repro.models.common`, with the same cast order so
that the two packages compute the same thing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize in fp32, cast back to x's dtype, then scale by `w`."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * w


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: [...]; returns cos/sin of shape [..., head_dim//2]."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate split halves (not interleaved pairs). x: [..., S, H, Hd];
    cos/sin: [..., S, Hd//2], broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def dense_init(gen: torch.Generator, fan_in: int, shape: tuple,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Normal(0, fan_in**-0.5) drawn in fp32 on the generator's device."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * fan_in ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape: tuple, dtype=torch.bfloat16) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * 0.02).to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down
