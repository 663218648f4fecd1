"""Public SSD-scan wrapper with the signature of the reference's
`repro.kernels.ssd_scan.ops.ssd_chunked`: (B, S, H, P) layout, device
dispatch.

CPU tensors go to the plain version (`ref.ssd_scan_ref`), as the
reference's wrapper runs its kernel in interpret mode on the CPU. CUDA
tensors go to the Hopper kernel, which reads the (B, S, H, P) and
(B, S, H) layouts through strides and treats the ragged tail as the
reference's identity padding steps, so nothing is transposed or padded
here. The reference's kernel casts each input to fp32 on its own and takes
any head dim; the Hopper kernel takes x, a, B, C of one type and P <= 64,
so this wrapper
- runs mixed float32/bfloat16 inputs through the float32 kernel, each
  input widened (exactly) to float32, y returned in x's dtype;
- splits P > 64 into blocks of at most 64 columns, one kernel call each
  (row p of y and of the state depends only on column p of x, so the
  split is exact) and joins the blocks; the call counts as one launch,
  though each block redoes the work that depends only on B and C.
The state size N stays limited to 128 (`kernel.MAX_STATE`) and the chunk
to 128; every configuration has N <= 128. There is no fallback: if the
kernel cannot be built or launched, this raises. Nor is there a backward
pass: on either device, a call that autograd would have to differentiate
raises (`refuse_autograd`), so the CPU and the card agree.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import refuse_autograd
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
    refuse_autograd("ssd_chunked", x, a, B_in, C_in, initial_state)
    s = x.shape[1]
    chunk = min(chunk, max(8, 1 << (s - 1).bit_length()))
    if x.device.type == "cpu":
        y, fin = ssd_scan_ref(x, a, B_in, C_in, initial_state)
    else:
        y, fin = kernel_scan(x, a, B_in, C_in, chunk=chunk, initial_state=initial_state)
    return y.to(x.dtype), fin.to(x.dtype)


def kernel_scan(x, a, B_in, C_in, *, chunk: int, initial_state=None):
    """The kernel path: widen mixed types, split P into blocks the kernel
    takes, call `kernel.ssd_scan` once per block. Returns y (in float32
    when the types were mixed) and the fp32 final state."""
    if len({t.dtype for t in (x, a, B_in, C_in)}) > 1:
        x, a, B_in, C_in = (t.float() for t in (x, a, B_in, C_in))
    P, width = x.shape[-1], kernel.MAX_HEADDIM
    if P <= width:
        return kernel.ssd_scan(x, a, B_in, C_in, chunk=chunk, initial_state=initial_state)
    ys, fins = [], []
    for p0 in range(0, P, width):
        cols = slice(p0, p0 + width)
        s0 = None if initial_state is None else initial_state[:, :, cols]
        y, fin = kernel.ssd_scan(x[..., cols], a, B_in, C_in, chunk=chunk, initial_state=s0,
                                 count=p0 == 0)
        ys.append(y)
        fins.append(fin)
    return torch.cat(ys, dim=-1), torch.cat(fins, dim=2)
