"""Grouped-query attention: full/sliding-window prefill and cached decode.

Torch counterparts of `repro.models.attention`. The plain paths are the
default; when `cfg.use_pallas` is set, the prefill path dispatches to the
flash-attention kernel (the Hopper kernel on CUDA tensors, its plain
version on CPU tensors). The enc-dec family's encoder attends without a
mask and its decoder across to the encoder through the plain paths, as
the reference's do.

The reference's `constrain` calls stand at their counterparts: the identity
without a sharding context, DTensor redistributions under one
(`repro_torch.sharding.ctx`). Under a mesh the flash-attention kernel runs
on each rank's local shard through `local_map`, heads over `model`, and a
decode step writes its K/V into the rank's own shard of the cache.
"""
from __future__ import annotations

import functools
from typing import Tuple, Union

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..sharding.ctx import _cur, constrain, hold_layout, rule, split_dim
from ..sharding.rules import placements

NEG_INF = -1e30

CHUNKED_THRESHOLD = 2048
CHUNK_Q = 512


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,S,H,Hd], k: [B,T,K,Hd] -> scores [B,K,G,S,T] with H = K*G."""
    H, Hd = q.shape[2], q.shape[3]
    K = k.shape[2]
    qg = split_dim(q, 2, K, H // K)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) / (Hd ** 0.5)


def _gqa_combine(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: [B,K,G,S,T], v: [B,T,K,Hd] -> [B,S,H,Hd]."""
    B, K, G, S, T = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, K * G, v.shape[-1])


def _expand_kv(k: torch.Tensor, G: int) -> torch.Tensor:
    """(B, T, K, Hd) -> (B, T, K*G, Hd): plain-MHA form. A DTensor keeps
    its kv-head layout for its gradient, which the merged heads' backward
    view needs."""
    if G == 1:
        return k
    B, T, K, Hd = k.shape
    return hold_layout(k[:, :, :, None, :].expand(B, T, K, G, Hd).reshape(B, T, K * G, Hd))


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
    inclusive). DTensors under a sharding context run on local shards."""
    if isinstance(q, DTensor) and _cur() is not None:
        return _local_heads(functools.partial(attend_full, causal=causal, window=window,
                                              q_offset=q_offset), q, k, v)
    B, S, H, Hd = q.shape
    T = k.shape[1]
    G = H // k.shape[2]
    k = constrain(_expand_kv(k, G), "bshd")
    v = constrain(_expand_kv(v, G), "bshd")
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() / (Hd ** 0.5)
    scores = constrain(scores, "bhst")
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = constrain(torch.softmax(scores, dim=-1).to(q.dtype), "bhst")
    return torch.einsum("bhst,bthd->bshd", probs, v)


def attend_cached(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Single-step decode: q [B,1,H,Hd] against a (possibly ring-buffer)
    KV cache [B,W,K,Hd]; `valid` [W] or [B,W] marks live slots. A DTensor
    cache under a sharding context is read where it lies (`_local_kv`)."""
    if isinstance(k_cache, DTensor) and _cur() is not None:
        return _local_kv(q, k_cache, v_cache, valid)
    scores = _gqa_scores(q, k_cache).float()  # [B,K,G,1,W]
    if valid.ndim == 1:
        vmask = valid[None, None, None, None, :]
    else:
        vmask = valid[:, None, None, None, :]
    scores = torch.where(vmask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_combine(probs, v_cache)


def attend_latent(q_lat: torch.Tensor, q_pe: torch.Tensor, c_cache: torch.Tensor,
                  pe_cache: torch.Tensor, valid: torch.Tensor, scale: float) -> torch.Tensor:
    """MLA's decode step in the absorbed form: the queries' no-rope parts
    already taken into the latent, q_lat [B,1,H,r], and their rope parts q_pe
    [B,1,H,dr] against the cache's latents c_cache [B,W,1,r] and rope keys
    pe_cache [B,W,1,dr] (one of each a slot, shared by every head); `valid`
    [W] marks live slots. Scores q_lat . c + q_pe . k_pe times `scale`, an
    fp32 softmax, and the probabilities over the latents: the output in the
    latent, [B,1,H,r]."""
    c, pe = c_cache[:, :, 0], pe_cache[:, :, 0]
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c).float()
              + torch.einsum("bshd,btd->bhst", q_pe, pe).float()) * scale
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q_lat.dtype)
    return torch.einsum("bhst,btr->bshr", probs, c)


def attend_cross(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional cross-attention (decoder -> encoder memory): q
    [B,S,H,Hd] over k/v [B,S_enc,K,Hd], no mask. DTensor k/v under a
    sharding context are read where they lie (`_local_kv`)."""
    if isinstance(k, DTensor) and _cur() is not None:
        return _local_kv(q, k, v, None)
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
    block, and under autograd each chunk is checkpointed (recomputed in the
    backward pass, as the reference's `jax.checkpoint` block is), so peak
    memory is O(B*H*chunk*S) in training too. A plain loop over chunks in
    place of the reference's scan."""
    B, S, H, Hd = q.shape
    if S % chunk:
        raise ValueError(f"seq {S} % chunk {chunk}")
    # Sliding-window locality: a q-chunk at offset o only sees keys in
    # [o - window + 1, o + chunk), so attend over a window-aligned span.
    span = S
    if window > 0:
        span = min(S, chunk + window)
        span = ((span + chunk - 1) // chunk) * chunk
    def block(q_blk, offset):
        q_blk = constrain(q_blk, "bshd")
        if span < S:
            start = min(max(offset + chunk - span, 0), S - span)
            out = attend_full(q_blk, k[:, start:start + span], v[:, start:start + span],
                              causal=causal, window=window, q_offset=offset - start)
        else:
            out = attend_full(q_blk, k, v, causal=causal, window=window, q_offset=offset)
        return constrain(out, "bshd")

    if torch.is_grad_enabled():
        block = functools.partial(checkpoint, block, use_reentrant=False)
    return torch.cat([block(q[:, o:o + chunk], o) for o in range(0, S, chunk)], dim=1)


def prefill_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0,
    use_pallas: bool = False,
) -> torch.Tensor:
    """`use_pallas` keeps the reference's config name: it selects the
    flash-attention kernel. On DTensors under a sharding context either path
    runs on each rank's local shards (`_local_heads`)."""
    if isinstance(q, DTensor) and _cur() is not None:
        return _local_heads(functools.partial(prefill_attention, window=window,
                                              use_pallas=use_pallas), q, k, v)
    if use_pallas:
        from ..kernels.flash_attention.ops import flash_attention

        return flash_attention(q, k, v, causal=True, window=window)
    S = q.shape[1]
    if S > CHUNKED_THRESHOLD and S % CHUNK_Q == 0:
        return attend_chunked(q, k, v, causal=True, window=window)
    return attend_full(q, k, v, causal=True, window=window)


def _local_heads(attend, q, k, v):
    """`attend` (q, k, v) -> out on each rank's shard under `local_map`:
    batch over the batch axes and heads over `model` (when H divides it),
    the "bshd" layout of every operand and of the output (so the scores are
    in the reference's "bhst" layout). Batch rows and heads are independent,
    so this is exact; the kernel sees local tensors, never DTensors, and
    DTensor propagates no sharding through the attention's own ops. When H
    divides `model` and K does not, K/V are first expanded to H heads
    (plain-MHA form, as `attend_full` does), so each rank holds the kv heads
    its query heads read."""
    ctx = _cur()
    mesh, m = ctx["mesh"], ctx["model"]
    H, K = q.shape[2], k.shape[2]
    if m is not None and H % ctx["sizes"][m] == 0 and K % ctx["sizes"][m] != 0:
        k, v = _expand_kv(k, H // K), _expand_kv(v, H // K)
    pl = placements(rule("bshd", tuple(q.shape), ctx), mesh)
    fn = local_map(attend, out_placements=list(pl), in_placements=(pl, pl, pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


def _local_kv(q, k, v, valid):
    """`attend_cached` (or, with `valid` None, `attend_cross`) on the local
    shards of DTensor K/V (B, W, K, Hd), in their own layout: q's batch and
    heads follow the cache's batch and kv heads. Over a length W sharded
    across ranks, each rank scores its slots and the softmax is taken
    across the shards: the max and the sum of exponentials are all-reduced
    over the ranks that split W, each rank's probabilities weigh its own V,
    and the partial outputs are summed (DTensor's all-reduce)."""
    mesh = k.device_mesh
    # the K/V layout kept: batch, length or kv heads split; anything else
    # (a head-dim split, a partial sum) is gathered first
    cpl = tuple(p if p.is_shard() and p.dim in (0, 1, 2) else Replicate() for p in k.placements)
    q_pl = tuple(Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2) else Replicate()
                 for p in cpl)
    w_dims = [i for i, p in enumerate(cpl) if p.is_shard(1)]
    if not w_dims:
        attend = attend_cross if valid is None else functools.partial(
            attend_cached, valid=valid)
        return local_map(attend, out_placements=list(q_pl), in_placements=(q_pl, cpl, cpl),
                         device_mesh=mesh, redistribute_inputs=True)(q, k, v)
    if valid is not None and valid.ndim != 1:
        raise ValueError("a cache sharded over its length takes a valid mask [W]")
    _, offset = compute_local_shape_and_global_offset(k.shape, mesh, cpl)
    groups = [(mesh, i) for i in w_dims]

    def body(q, k, v):
        scores = _gqa_scores(q, k).float()  # [B,K,G,S,W_local]
        if valid is not None:
            live = valid[offset[1]:offset[1] + k.shape[1]]
            scores = torch.where(live[None, None, None, None, :], scores, NEG_INF)
        top = scores.amax(-1, keepdim=True)
        for g in groups:
            top = funcol.all_reduce(top, "max", g)
        e = torch.exp(scores - top)
        total = e.sum(-1, keepdim=True)
        for g in groups:
            total = funcol.all_reduce(total, "sum", g)
        return _gqa_combine((e / total).to(q.dtype), v)

    out_pl = tuple(Partial("sum") if i in w_dims else p for i, p in enumerate(q_pl))
    out = local_map(body, out_placements=list(out_pl), in_placements=(q_pl, cpl, cpl),
                    device_mesh=mesh, redistribute_inputs=True)(q, k, v)
    return out.redistribute(mesh, q_pl)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """cache[:, slot] = new, in place, `slot` a (1,) index tensor on the
    cache's device, so that no host reads it. On a DTensor cache (B, W, K,
    Hd) the write goes into the local shard of the rank that holds the slot:
    `new` is brought to the cache's placements (W replicated) and written at
    the slot's local index, so a cache sharded over its length stays in
    place; a rank whose shard lacks the slot writes its own entry back."""
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, slot, new.to(cache.dtype))
        return
    mesh, pl = cache.device_mesh, cache.placements
    new = new.redistribute(mesh, [Replicate() if p.is_shard(1) else p for p in pl]).to_local()
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    if shape[1] == 0:
        return
    local, at = cache.to_local(), slot - offset[1]
    held = (at >= 0) & (at < shape[1])
    at = at.clamp(0, shape[1] - 1)
    local.index_copy_(1, at, torch.where(held, new.to(local.dtype), local.index_select(1, at)))


def cache_update(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: Union[int, torch.Tensor],
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write one step's K/V at `pos` (ring buffer when window > 0), IN PLACE
    on the given caches, which are returned with the valid-slot mask [W].

    Unlike the reference's functional update this mutates its arguments, so
    a decode step does not copy the whole cache. The slot is clamped to the
    last one as `jax.lax.dynamic_update_slice` clamps its start index.

    `pos` is a 0-d integer tensor on the cache's device (an int is made
    one): the slot and the mask are computed there and nothing waits for
    the host, so the update can be captured in a CUDA graph and replayed
    at the next position.
    """
    pos, W = torch.as_tensor(pos, device=k_cache.device), k_cache.shape[1]
    slot = (pos % W if window > 0 else pos).clamp(max=W - 1).reshape(1)
    _write_slot(k_cache, k_new, slot)
    _write_slot(v_cache, v_new, slot)
    valid = torch.arange(W, device=k_cache.device) <= pos  # all live once pos >= W
    return k_cache, v_cache, valid
