"""Public flash-attention wrapper: (B, S, H, D) layout, device dispatch.

CPU tensors go to the plain version (`ref.flash_attention_ref`), as the
reference's wrapper runs its kernel in interpret mode on the CPU. CUDA
tensors go to the Hopper kernel, which reads the (B, S, H, D) layout
through strides and masks the ragged tail itself, so nothing is
transposed or padded here. There is no fallback: if the kernel cannot be
built or launched, this raises.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import flash_attention_ref


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, K, D)
    v: torch.Tensor,  # (B, S, K, D)
    *,
    causal: bool = True,
    window: int = 0,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """`block_q`/`block_k` are accepted for signature parity with the
    reference; the kernel's tiles are fixed at 64 rows."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return kernel.flash_attention_bshd(q, k, v, causal=causal, window=window)
