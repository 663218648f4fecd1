"""Public SSD-scan wrapper with the signature of the reference's
`repro.kernels.ssd_scan.ops.ssd_chunked`: (B, S, H, P) layout, device
dispatch.

CPU tensors go to the plain version (`ref.ssd_scan_ref`), as the
reference's wrapper runs its kernel in interpret mode on the CPU. CUDA
tensors go to the Hopper kernel, which reads the (B, S, H, P) and
(B, S, H) layouts through strides and treats the ragged tail as the
reference's identity padding steps, so nothing is transposed or padded
here. There is no fallback: if the kernel cannot be built or launched,
this raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel
from .ref import ssd_scan_ref


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P) -- pre-multiplied by dt
    a: torch.Tensor,  # (B, S, H)
    B_in: torch.Tensor,  # (B, S, N)
    C_in: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final_state (B,H,P,N)), both in x's dtype as
    the reference's wrapper returns them."""
    s = x.shape[1]
    chunk = min(chunk, max(8, 1 << (s - 1).bit_length()))
    if x.device.type == "cpu":
        y, fin = ssd_scan_ref(x, a, B_in, C_in, initial_state)
    else:
        y, fin = kernel.ssd_scan(x, a, B_in, C_in, chunk=chunk, initial_state=initial_state)
    return y.to(x.dtype), fin.to(x.dtype)
