"""Grouped-query attention: full/sliding-window prefill and cached decode.

Torch counterparts of `repro.models.attention`. The plain paths are the
default; when `cfg.use_pallas` is set, the prefill path dispatches to the
flash-attention kernel (the Hopper kernel on CUDA tensors, its plain
version on CPU tensors). The enc-dec family's encoder attends without a
mask and its decoder across to the encoder through the plain paths, as
the reference's do.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30

CHUNKED_THRESHOLD = 2048
CHUNK_Q = 512


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,S,H,Hd], k: [B,T,K,Hd] -> scores [B,K,G,S,T] with H = K*G."""
    B, S, H, Hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, Hd)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) / (Hd ** 0.5)


def _gqa_combine(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: [B,K,G,S,T], v: [B,T,K,Hd] -> [B,S,H,Hd]."""
    B, K, G, S, T = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, K * G, v.shape[-1])


def _expand_kv(k: torch.Tensor, G: int) -> torch.Tensor:
    """(B, T, K, Hd) -> (B, T, K*G, Hd): plain-MHA form."""
    if G == 1:
        return k
    B, T, K, Hd = k.shape
    return k[:, :, :, None, :].expand(B, T, K, G, Hd).reshape(B, T, K * G, Hd)


def attend_full(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Self-attention over equal-length q/k (prefill). window > 0 applies
    sliding-window masking (each query sees the last `window` keys,
    inclusive)."""
    B, S, H, Hd = q.shape
    T = k.shape[1]
    G = H // k.shape[2]
    k = _expand_kv(k, G)
    v = _expand_kv(v, G)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() / (Hd ** 0.5)
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def attend_cached(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Single-step decode: q [B,1,H,Hd] against a (possibly ring-buffer)
    KV cache [B,W,K,Hd]; `valid` [W] or [B,W] marks live slots."""
    scores = _gqa_scores(q, k_cache).float()  # [B,K,G,1,W]
    if valid.ndim == 1:
        vmask = valid[None, None, None, None, :]
    else:
        vmask = valid[:, None, None, None, :]
    scores = torch.where(vmask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_combine(probs, v_cache)


def attend_cross(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional cross-attention (decoder -> encoder memory): q
    [B,S,H,Hd] over k/v [B,S_enc,K,Hd], no mask."""
    scores = _gqa_scores(q, k).float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_combine(probs, v)


def attend_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = CHUNK_Q,
) -> torch.Tensor:
    """q-chunked attention: scores materialize only per (chunk x span)
    block. A plain loop over chunks (the reference's scan without its
    activation checkpointing; the port has no backward pass yet)."""
    B, S, H, Hd = q.shape
    if S % chunk:
        raise ValueError(f"seq {S} % chunk {chunk}")
    # Sliding-window locality: a q-chunk at offset o only sees keys in
    # [o - window + 1, o + chunk), so attend over a window-aligned span.
    span = S
    if window > 0:
        span = min(S, chunk + window)
        span = ((span + chunk - 1) // chunk) * chunk
    out = []
    for offset in range(0, S, chunk):
        q_blk = q[:, offset:offset + chunk]
        if span < S:
            start = min(max(offset + chunk - span, 0), S - span)
            out.append(attend_full(
                q_blk, k[:, start:start + span], v[:, start:start + span],
                causal=causal, window=window, q_offset=offset - start))
        else:
            out.append(attend_full(q_blk, k, v, causal=causal, window=window,
                                   q_offset=offset))
    return torch.cat(out, dim=1)


def prefill_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0,
    use_pallas: bool = False,
) -> torch.Tensor:
    """`use_pallas` keeps the reference's config name: it selects the
    flash-attention kernel."""
    if use_pallas:
        from ..kernels.flash_attention.ops import flash_attention

        return flash_attention(q, k, v, causal=True, window=window)
    S = q.shape[1]
    if S > CHUNKED_THRESHOLD and S % CHUNK_Q == 0:
        return attend_chunked(q, k, v, causal=True, window=window)
    return attend_full(q, k, v, causal=True, window=window)


def cache_update(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: int,
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write one step's K/V at `pos` (ring buffer when window > 0), IN PLACE
    on the given caches, which are returned with the valid-slot mask [W].

    Unlike the reference's functional update this mutates its arguments, so
    a decode step does not copy the whole cache. The slot is clamped to the
    last one as `jax.lax.dynamic_update_slice` clamps its start index.
    """
    W = k_cache.shape[1]
    slot = min(pos % W if window > 0 else pos, W - 1)
    k_cache[:, slot:slot + 1] = k_new.to(k_cache.dtype)
    v_cache[:, slot:slot + 1] = v_new.to(v_cache.dtype)
    if pos >= W:  # after wrap every slot is live
        valid = torch.ones(W, dtype=torch.bool, device=k_cache.device)
    else:
        valid = torch.arange(W, device=k_cache.device) <= pos
    return k_cache, v_cache, valid
