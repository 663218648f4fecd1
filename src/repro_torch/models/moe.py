"""Mixture-of-Experts FFN: top-k routing with two dispatch paths.

Torch counterpart of `repro.models.moe`, plain tensor ops (the reference
has no Pallas kernel here: routing, dispatch and the expert products are
XLA ops there, batched matrix products here).

`moe_ffn_dense` is the readable oracle (computes every expert on every
token, then masks); it is for smoke-scale tests only: at full width its
(E, T, D) expert outputs do not fit a card.

`moe_ffn_sorted` is the serving path: sort-based gather into per-expert
capacity buckets with static shapes, so expert work is proportional to
E x capacity, and a pair whose expert is full is dropped as the
reference drops it. The combine adds each token's k contributions one
after another in expert-ascending order, the order in which the
reference's scatter-add applies them, with no atomics: its bits do not
change from run to run.

`moe_ffn_ep` (expert parallelism under a mesh) is not ported; without a
mesh the reference returns `moe_ffn_sorted`, which the port's layers call
directly. The reference's `constrain` calls are the identity without a
mesh and are dropped.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig


def route(x: torch.Tensor, router_w: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (T, D); router_w: (D, E). Returns (weights (T,k), idx (T,k), aux).

    Softmax-then-topk in float32 (whatever the model's type) with
    renormalization; aux carries the load-balance loss (Switch-style) and
    router z-loss. The picks come in descending probability, the lower
    expert first on a tie, as `jax.lax.top_k` gives them: a stable
    descending sort guarantees that order on every device (`torch.topk`
    does not keep it on a tie, nor even pick the lower of two tied experts).
    """
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :k], idx[:, :k]
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    E = router_w.shape[1]
    # load-balance: E * sum_e (fraction of tokens to e) * (mean prob of e)
    load = F.one_hot(idx, E).float().sum(1).mean(0)
    importance = probs.mean(0)
    lb_loss = E * torch.sum(load * importance)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return weights, idx, {"lb_loss": lb_loss, "z_loss": z_loss}


def _expert_ffn(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, D); weights: (E, D, F) / (E, F, D)."""
    g = torch.bmm(xe, w_gate)
    u = torch.bmm(xe, w_up)
    return torch.bmm(F.silu(g) * u, w_down)


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens, the reference's Python arithmetic in
    its order of operations (1 at decode's T = B for qwen3-moe)."""
    return max(1, int(T * cfg.experts_per_token / cfg.num_experts * cfg.moe_capacity_factor))


def bucket_slots(idx: torch.Tensor, E: int, C: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based bucketing of the (token, pick) pairs of idx (T, k): the
    stable expert-sorted order of the flat pairs, and in that order each
    pair's slot e * C + rank in its expert's bucket (E * C, the sentinel,
    once the bucket is full) and whether it was kept."""
    flat_e = idx.reshape(-1)  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # rank of each pair within its expert group
    group_start = torch.searchsorted(sorted_e, torch.arange(E, device=idx.device), side="left")
    rank = torch.arange(flat_e.numel(), device=idx.device) - group_start[sorted_e]
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)  # overflow -> sentinel
    return order, slot, keep


def moe_ffn_sorted(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (T, D) -> (out (T, D) in x's type, aux with "lb_loss",
    "z_loss" and "dropped", the count of (token, expert) pairs whose
    expert was full)."""
    T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, T)
    weights, idx, aux = route(x, p["router"], k)
    order, slot, keep = bucket_slots(idx, E, C)
    tok = order // k

    # gather tokens into (E, C, D) buckets; the sentinel row is zeros. Every
    # dropped pair writes T into the one sentinel slot: equal writes.
    table = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    table[slot] = torch.where(keep, tok, T)
    x_pad = torch.cat([x, x.new_zeros(1, D)])
    xe = x_pad[table[:E * C]].reshape(E, C, D)

    ye = _expert_ffn(xe, p["w_gate"], p["w_up"], p["w_down"])  # (E, C, D)

    # combine weights on the bucket outputs (dropped pairs contribute zero)
    ye_flat = torch.cat([ye.reshape(E * C, D), ye.new_zeros(1, D)])
    contrib = ye_flat[slot] * keep[:, None].to(ye.dtype)
    w_sorted = weights.reshape(-1)[order].to(contrib.dtype)
    out = _combine(contrib * w_sorted[:, None], order, T, k, x.dtype)
    aux = dict(aux, dropped=(~keep).sum())
    return out, aux


def _combine(contrib: torch.Tensor, order: torch.Tensor, T: int, k: int,
             dtype: torch.dtype) -> torch.Tensor:
    """out[t] = the sum of token t's k rows of `contrib` (T*k, D), which
    lie in the sorted order `order` (pair j of token j // k at place p where
    order[p] == j). The reference's scatter-add applies them in place order,
    which is expert-ascending for a token; here they are added one after
    another from zero in that order, in `dtype`, without atomics."""
    places = torch.empty_like(order)
    places[order] = torch.arange(T * k, device=order.device)
    places = torch.sort(places.reshape(T, k), dim=1).values
    out = torch.zeros((T, contrib.shape[1]), dtype=dtype, device=contrib.device)
    for r in range(k):
        out = out + contrib[places[:, r]]
    return out


def moe_ffn_dense(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Oracle: every expert computes every token; combine masks select."""
    T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    weights, idx, aux = route(x, p["router"], k)
    xe = x[None].expand(E, T, D)
    ye = _expert_ffn(xe, p["w_gate"], p["w_up"], p["w_down"])  # (E, T, D)
    combine = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, idx, weights)
    out = torch.einsum("te,etd->td", combine.to(x.dtype), ye)
    return out, aux


def moe_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": (D, E),
        "w_gate": (E, D, F_),
        "w_up": (E, D, F_),
        "w_down": (E, F_, D),
    }
