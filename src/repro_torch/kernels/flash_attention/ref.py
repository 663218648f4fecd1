"""Plain torch version of the flash-attention kernel (GQA, causal, window).

Mirrors `repro.kernels.flash_attention.ref.flash_attention_ref`: fp32
scores and softmax, masked entries at -1e30, output cast to q's dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, K, D)
    v: torch.Tensor,  # (B, S, K, D)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / (D ** 0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
