"""Shared model components: norms, RoPE, initializers, cross-entropy, SwiGLU.

Torch counterparts of `repro.models.common`, with the same cast order so
that the two packages compute the same thing. `swiglu` keeps the
reference's `constrain` call on its hidden layer; `cross_entropy` takes
logits sharded over the vocabulary (a DTensor) too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..sharding.ctx import constrain


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


def yarn_inv_freq(dim: int, theta: float, factor: float, original: int, beta_fast: float,
                  beta_slow: float, device=None) -> torch.Tensor:
    """YaRN's rotary frequencies (DeepSeek-V3's `yarn_find_correction_range`
    and linear ramp), (dim // 2,) fp32: each pair's plain frequency theta **
    (-2i / dim), divided by `factor` where it turns fewer than `beta_slow`
    times over the `original` context, kept where it turns more than
    `beta_fast` times, and mixed linearly between the two dims those bound."""
    def dim_at(rotations: float) -> float:
        return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(dim_at(beta_fast)), 0)
    high = min(math.ceil(dim_at(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    extra = 1.0 / (theta ** (i / (dim // 2)))
    ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
    return extra / factor * ramp + extra * (1.0 - ramp)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's magnitude scale, 0.1 mscale ln(factor) + 1 (1 at factor 1)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


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


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token-level CE in fp32 over the targets that are not
    `ignore_id`. logits [..., V], targets [...] int.

    On a DTensor, whose vocabulary may be sharded, the log-sum-exp is taken
    from each shard's max and sum of exponentials and the gold logit picked
    by a mask: DTensor reduces both over the shards (all-reduces), where a
    gather along the sharded vocabulary has no sharding rule."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        top = logits.detach().amax(-1, keepdim=True)
        logz = torch.log(torch.exp(logits - top).sum(-1)) + top[..., 0]
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        pick = vocab == targets.long().clamp(min=0)[..., None]
        gold = torch.where(pick, logits, 0.0).sum(-1)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long().clamp(min=0)[..., None])[..., 0]
    mask = (targets != ignore_id).float()
    return torch.sum((logz - gold) * mask) / mask.sum().clamp(min=1.0)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g) * u
    if h.ndim == 3:
        h = constrain(h, "bsf")
    return h @ w_down
