"""Pieces the plain references share: the precision a product is computed
in, RMS norm, rotary embedding and the random weights' draws.

Nothing here imports the program. Every product goes through
`Precision.mm`, so the same forward pass runs as the float32 reference
(TF32 off) and as the low-precision control, in which each operand of a
product is first rounded to float8 e4m3 with a per-tensor scale, as an
fp8 GEMM with float32 accumulation would see it.
"""
from __future__ import annotations

import torch

F8 = torch.float8_e4m3fn
F8_MAX = 448.0


class Precision:
    """`float32`: operands as they are. `float8_e4m3`: each operand of a
    product, and each cache entry as stored, rounded to e4m3 under a
    per-tensor scale that maps its largest magnitude to 448."""

    NAMES = ("float32", "float8_e4m3")

    def __init__(self, name: str = "float32"):
        if name not in self.NAMES:
            raise ValueError(f"precision {name!r}: one of {self.NAMES}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        scale = F8_MAX / t.abs().amax().clamp(min=1e-30)
        return (t * scale).to(F8).float() / scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


def tf32_off() -> None:
    """A float32 product on the card may run in TF32 unless both switches
    are off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (B, T, heads, d) on rotated halves (the
    published form of Qwen2's `rotate_half`)."""
    d = x.shape[-1]
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half))
    ang = (positions.double()[:, None] * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def normal(gen: torch.Generator, shape, std: float, dtype, mean: float = 0.0) -> torch.Tensor:
    """One draw on the generator's device, made in float32 and cast once."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (t * std + mean).to(dtype)


def uniform(gen: torch.Generator, shape, lo: float, hi: float, dtype) -> torch.Tensor:
    t = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (lo + (hi - lo) * t).to(dtype)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| in the Frobenius norm, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-300))
