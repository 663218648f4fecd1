"""Public flash-attention wrapper: (B, S, H, D) layout, device dispatch.

CPU tensors go to the plain version (`ref.flash_attention_ref`), as the
reference's wrapper runs its kernel in interpret mode on the CPU. CUDA
tensors go to the Hopper kernel, which reads the (B, S, H, D) layout
through strides and masks the ragged tail itself, so nothing is
transposed here; a head dim other than 64 or 128 (any D up to 128, as the
reference takes) is zero-padded by the kernel's binding. v may have a head
dim of its own: the kernel is built for q/k 192 with v 128 (MLA) too. There is no
fallback: if the kernel cannot be built or launched, this raises. Nor is
there a backward pass: on either device, a call that autograd would have
to differentiate raises (`refuse_autograd`), so the CPU and the card agree.
"""
from __future__ import annotations

import torch

from .. import refuse_autograd
from . import kernel
from .ref import flash_attention_ref


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, K, D)
    v: torch.Tensor,  # (B, S, K, Dv): Dv = D, or (D, Dv) = (192, 128)
    *,
    causal: bool = True,
    window: int = 0,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """`block_q`/`block_k` are accepted for signature parity with the
    reference; the kernel's tiles are fixed. bfloat16: blocks of 128 q rows
    (two warpgroups of 64) over kv tiles of 64 keys in a 3-stage ring.
    float32: blocks of 64 q rows over double-buffered kv tiles of 64 keys."""
    refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return kernel.flash_attention_bshd(q, k, v, causal=causal, window=window)
