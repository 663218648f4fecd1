"""Plain torch version of the SSD scan kernel: the step-by-step recurrence.

Mirrors `repro.kernels.ssd_scan.ref.ssd_scan_ref`: the state is carried in
fp32, `y` comes back in x's dtype and the final state in fp32. A Python
loop over the sequence; only the CPU wrapper and the checks use it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan_ref(
    x: torch.Tensor,  # (B, S, H, P) -- pre-multiplied by dt
    a: torch.Tensor,  # (B, S, H)
    B_in: torch.Tensor,  # (B, S, N)
    C_in: torch.Tensor,  # (B, S, N)
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    n = B_in.shape[-1]
    if initial_state is None:
        st = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    else:
        st = initial_state.float()
    ys = []
    for t in range(s):
        st = st * torch.exp(a[:, t].float())[..., None, None]
        st = st + torch.einsum("bhp,bn->bhpn", x[:, t].float(), B_in[:, t].float())
        ys.append(torch.einsum("bhpn,bn->bhp", st, C_in[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), st
