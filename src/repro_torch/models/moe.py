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

`moe_ffn_dropless` drops nothing (`cfg.moe_capacity_factor` 0): the
(token, expert) pairs sorted by expert, each expert's contiguous segment
through its SwiGLU, by one grouped product a projection
(`torch._grouped_mm` in bf16, which never reads an expert that receives
no pair; in other types one batched product over zero-padded per-expert
buckets), with nothing read on the host. The combine weighs each token's
k rows and sums them in pick order, without atomics. Where the layer holds
an expert share (`cfg.expert_share`: experts [first_expert, first_expert +
num_experts) of the router's `n_router`, as one rank of expert parallelism
holds them), the router still ranks every expert, the pairs of other
experts sort last and go through no product, and they add nothing: the
layer's output is its share's part of the whole.

`route_tokens` picks the router: `route`'s softmax, or DeepSeek-V3's
`route_grouped` (sigmoid scores, a bias that steers the choice only,
group-limited), then `routed_scaling_factor`.

`moe_ffn_ep` is expert parallelism under a mesh (`repro_torch.sharding.
ctx`), the reference's `shard_map` body on each rank's local tensors
through `local_map`: every model-rank routes its data shard's tokens and
computes only its E / `model` experts at the capacity of the local
tokens; the partial outputs are summed over `model`. Without a usable
mesh it is `moe_ffn_sorted`. On a DTensor `moe_ffn_sorted` (the decode
step's MoE, as in the reference) keeps its semantics, every token routed
at the capacity of all T tokens, and runs the same way with the tokens
gathered, expert-parallel when `model` divides E. The collectives are
DTensor redistributions (functional collectives underneath): the expert
weights gathered over `data`, the partial outputs all-reduced over
`model`, the aux losses averaged over the batch axes.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..sharding.ctx import _cur, constrain
from ..sharding.rules import axis_sizes, batch_axes, placements


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


def route_grouped(x: torch.Tensor, router_w: torch.Tensor, bias: torch.Tensor, k: int,
                  n_group: int, topk_group: int, norm: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """DeepSeek-V3's router (`noaux_tc`), in float32: s = sigmoid(x W_r),
    the choice on c = s + bias. A group's score is the sum of its two best
    c; the best `topk_group` groups are kept and the other experts' c set to
    0.0, the fill `transformers`' DeepseekV3TopkRouter uses (DeepSeek's own
    code uses -inf; the two pick alike while a kept group holds k experts
    with c > 0). The picks are the top k of that, in descending order,
    the lower expert first on a tie, as `route` gives them; the gates are s
    at the picks, over their sum + 1e-20 when `norm`. Returns (gates (T, k),
    idx (T, k), aux): aux's "lb_loss" is `route`'s Switch form on the
    normalized scores, its "z_loss" 0 (the router has no softmax)."""
    s = torch.sigmoid(x.float() @ router_w.float())
    c = s + bias.float()
    T, E = c.shape
    top2 = c.view(T, n_group, E // n_group).topk(2, dim=-1).values.sum(-1)
    kept = torch.sort(top2, dim=-1, descending=True, stable=True).indices[:, :topk_group]
    in_kept = torch.zeros_like(top2, dtype=torch.bool).scatter_(1, kept, True)
    choice = c.masked_fill(~in_kept.repeat_interleave(E // n_group, dim=1), 0.0)
    idx = torch.sort(choice, dim=-1, descending=True, stable=True).indices[:, :k]
    gates = s.gather(1, idx)
    if norm:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    load = F.one_hot(idx, E).float().sum(1).mean(0)
    importance = (s / s.sum(-1, keepdim=True)).mean(0)
    return gates, idx, {"lb_loss": E * torch.sum(load * importance),
                        "z_loss": torch.zeros((), dtype=torch.float32, device=x.device)}


def route_tokens(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """The configuration's router over x (T, D): (gates, idx over all
    `n_router` experts, aux); the gates times `routed_scaling_factor`."""
    if cfg.router_scoring == "sigmoid":
        gates, idx, aux = route_grouped(x, p["router"], p["router_bias"], cfg.experts_per_token,
                                        cfg.n_group, cfg.topk_group, cfg.norm_topk_prob)
    else:
        gates, idx, aux = route(x, p["router"], cfg.experts_per_token)
    if cfg.routed_scaling_factor != 1.0:
        gates = gates * cfg.routed_scaling_factor
    return gates, idx, aux


def _expert_ffn(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, D); weights: (E, D, F) / (E, F, D)."""
    g = torch.bmm(xe, w_gate)
    u = torch.bmm(xe, w_up)
    return torch.bmm(F.silu(g) * u, w_down)


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens, the reference's Python arithmetic in
    its order of operations (1 at decode's T = B for qwen3-moe)."""
    if cfg.dropless:
        raise ValueError(f"{cfg.name} is dropless: its MoE has no capacity (moe_ffn_dropless)")
    return max(1, int(T * cfg.experts_per_token / cfg.num_experts * cfg.moe_capacity_factor))


def bucket_slots(idx: torch.Tensor, E: int, C: int, e_lo: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based bucketing of the (token, pick) pairs of idx (T, k) into
    the E experts [e_lo, e_lo + E): the stable expert-sorted order of the
    flat pairs (pairs of other experts last), and in that order each pair's
    slot e * C + rank in its expert's bucket (E * C, the sentinel, once the
    bucket is full or for another expert) and whether it was kept. With
    e_lo = 0 and E all the experts, every pair is bucketed."""
    flat_e = idx.reshape(-1)  # (T*k,)
    local = torch.where((flat_e >= e_lo) & (flat_e < e_lo + E), flat_e - e_lo, E)
    order = torch.argsort(local, stable=True)
    sorted_e = local[order]
    # rank of each pair within its expert group
    group_start = torch.searchsorted(sorted_e, torch.arange(E + 1, device=idx.device),
                                     side="left")
    rank = torch.arange(flat_e.numel(), device=idx.device) - group_start[sorted_e]
    keep = (sorted_e < E) & (rank < C)
    slot = torch.where(keep, sorted_e * C + rank, E * C)  # overflow -> sentinel
    return order, slot, keep


def _experts_local(x: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, *,
                   C: int, e_lo: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch, expert products and combine for the experts [e_lo, e_lo +
    E) whose weights are given ((E, D, F) / (E, F, D)); the pairs of other
    experts contribute zero. Returns (out (T, D) in x's type, keep)."""
    T, D = x.shape
    E, k = w_gate.shape[0], idx.shape[1]
    order, slot, keep = bucket_slots(idx, E, C, e_lo)
    tok = order // k

    # gather tokens into (E, C, D) buckets; the sentinel row is zeros. Every
    # dropped pair writes T into the one sentinel slot: equal writes.
    table = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    table[slot] = torch.where(keep, tok, T)
    x_pad = torch.cat([x, x.new_zeros(1, D)])
    xe = constrain(x_pad[table[:E * C]].reshape(E, C, D), "ecd")

    ye = constrain(_expert_ffn(xe, w_gate, w_up, w_down), "ecd")  # (E, C, D)

    # combine weights on the bucket outputs (dropped pairs contribute zero)
    ye_flat = torch.cat([ye.reshape(E * C, D), ye.new_zeros(1, D)])
    contrib = ye_flat[slot] * keep[:, None].to(ye.dtype)
    w_sorted = weights.reshape(-1)[order].to(contrib.dtype)
    return _combine(contrib * w_sorted[:, None], order, T, k, x.dtype), keep


def moe_ffn_sorted(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (T, D) -> (out (T, D) in x's type, aux with "lb_loss",
    "z_loss" and "dropped", the count of (token, expert) pairs whose
    expert was full). A DTensor x runs on its mesh (`_sharded_moe`, all T
    tokens on every rank) with the same routing and capacity, "dropped"
    then 0 as in `moe_ffn_ep`."""
    if isinstance(x, DTensor):
        return _sharded_moe(cfg, p, x, shard_tokens=False)
    weights, idx, aux = route(x, p["router"], cfg.experts_per_token)
    out, keep = _experts_local(x, weights, idx, p["w_gate"], p["w_up"], p["w_down"],
                               C=capacity(cfg, x.shape[0]))
    return out, dict(aux, dropped=(~keep).sum())


#: Calls of `moe_ffn_ep` that ran expert-parallel since the count was last set to 0.
ep_calls = 0


def moe_ffn_ep(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert-parallel MoE FFN: x (T, D) globally, rows sharded over the
    batch axes. Tokens never leave their data shard: every model-rank
    routes the same local tokens at C = max(1, int(T_loc k / E cf)),
    computes only its E / `model` experts, and one all-reduce over `model`
    combines the partial outputs. Without a usable mesh (no context,
    disabled, no `model` axis, E % model != 0 or T % batch != 0) it is
    `moe_ffn_sorted`. Under one, x must be a DTensor. "dropped" is 0, as in
    the reference."""
    global ep_calls
    ctx = _cur()
    if ctx is None or not ctx["enabled"] or ctx["model"] is None:
        return moe_ffn_sorted(cfg, p, x)
    sizes = ctx["sizes"]
    if cfg.num_experts % sizes["model"] or x.shape[0] % _batch_size(sizes):
        return moe_ffn_sorted(cfg, p, x)
    if not isinstance(x, DTensor):
        raise TypeError("moe_ffn_ep under a sharding context takes a DTensor")
    ep_calls += 1
    return _sharded_moe(cfg, p, x, shard_tokens=True)


def _batch_size(sizes: Dict[str, int]) -> int:
    return math.prod(sizes[a] for a in batch_axes(sizes))


def _sharded_moe(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: DTensor, *,
                 shard_tokens: bool) -> Tuple[DTensor, Dict[str, torch.Tensor]]:
    """The reference's `shard_map` body on x's mesh under `local_map`. Each
    rank takes its tokens (its data shard's rows if `shard_tokens`, else all
    T rows, gathered), the router replicated and its experts' weights
    gathered over `data`: its E / `model` experts when `model` divides E
    (expert parallelism), else all E. It routes the tokens, buckets its
    experts at the capacity of the tokens it holds, runs their products and
    combines them (expert order, no atomics). The output is a partial sum
    over `model` under expert parallelism, and the aux losses (of each
    rank's tokens) are averaged over the batch axes: each rank's share is
    divided by the ranks that sum it, so that every partial is a sum and
    its gradient reaches each rank whole. The inputs' gradients are
    partial sums where the ranks' work is split: over `model` for the
    tokens and the router under expert parallelism, over the batch axes
    for the router and the expert weights."""
    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    E = cfg.num_experts
    ep = "model" in sizes and E % sizes["model"] == 0
    E_loc = E // sizes["model"] if ep else E
    e_lo = mesh.get_local_rank("model") * E_loc if ep else 0
    token_axes = batch_axes(sizes) if shard_tokens else ()
    split = tuple(n for n in sizes if n in token_axes or (ep and n == "model"))
    share = math.prod(sizes[n] for n in split)
    C = capacity(cfg, x.shape[0] // (_batch_size(sizes) if shard_tokens else 1))

    def body(x_l, router, wg, wu, wd):
        weights, idx, aux = route(x_l, router, cfg.experts_per_token)
        out, _ = _experts_local(x_l, weights, idx, wg, wu, wd, C=C, e_lo=e_lo)
        return out, aux["lb_loss"] / share, aux["z_loss"] / share

    def partial_over(axes, base):
        return tuple(Partial("sum") if n in axes else pl for n, pl in zip(sizes, base))

    rows = placements((token_axes or None, None), mesh)
    rep = placements((), mesh)
    experts = placements(("model" if ep else None, None, None), mesh)
    model = ("model",) if ep else ()
    mean = partial_over(split, rep)
    fn = local_map(body, device_mesh=mesh, redistribute_inputs=True,
                   out_placements=(partial_over(model, rows), mean, mean),
                   in_placements=(rows, rep, experts, experts, experts),
                   in_grad_placements=(partial_over(model, rows), mean,
                                       *[partial_over(token_axes, experts)] * 3))
    out, lb, zl = fn(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    return out.redistribute(mesh, rows), {
        "lb_loss": lb.redistribute(mesh, rep), "z_loss": zl.redistribute(mesh, rep),
        "dropped": torch.zeros((), dtype=torch.int32, device=x.device)}


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


def segments_grouped(xs: torch.Tensor, counts: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, w_down: torch.Tensor, most: int) -> torch.Tensor:
    """SwiGLU of each expert's contiguous segment of xs (P, D), segment e
    `counts[e]` rows long and none longer than `most`; nothing waits for
    the host, so a decode step that runs it can be captured in a CUDA
    graph. In bf16, one grouped product a projection (`torch._grouped_mm`).
    Its other types walk the groups on the host, reading the offsets there,
    so in them the rows are put in zero-padded buckets (E, most, D), each
    expert's rows in its own, and go through one batched product a
    projection over the experts: memory O(E * most * (D + F)), the weights
    read once. Rows past the last segment (an expert share's pairs of other
    experts) go through no product: in bf16 their output rows hold whatever
    the grouped product left there, in other types zeros."""
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    if xs.dtype == torch.bfloat16:
        def mm(a, w):
            return torch._grouped_mm(a, w, offs=offs)
        return mm(F.silu(mm(xs, w_gate)) * mm(xs, w_up), w_down)
    E, (P, D) = counts.shape[0], xs.shape
    rows = torch.arange(P, dtype=torch.int32, device=xs.device)
    expert = torch.searchsorted(offs, rows, right=True)
    held = expert < E
    expert = expert.clamp(max=E - 1)
    # a row past the last segment goes to the one spare row, E * most
    at = torch.where(held, expert * most + rows - (offs - counts)[expert], E * most)
    buckets = xs.new_zeros(E * most + 1, D).index_copy_(0, at, xs)[:E * most].view(E, most, D)
    h = F.silu(torch.bmm(buckets, w_gate)) * torch.bmm(buckets, w_up)
    return torch.cat([torch.bmm(h, w_down).view(E * most, D), xs.new_zeros(1, D)])[at]


def moe_ffn_dropless(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (T, D) -> (out (T, D) in x's type, aux): every (token, expert)
    pair on a held expert computed, only the experts that receive pairs
    read. aux has "lb_loss", "z_loss", "dropped" (0) and, for an expert
    share, "held_pairs", the pairs on held experts (a device tensor)."""
    T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    weights, idx, aux = route_tokens(cfg, p, x)
    flat = idx.reshape(-1)
    if cfg.expert_share:
        flat = flat - cfg.first_expert
        flat = torch.where((flat >= 0) & (flat < E), flat, E)  # E: held elsewhere, sorts last
    order = torch.argsort(flat, stable=True)
    # a scatter, not `bincount`, which reads its input's max on the host
    bins = E + 1 if cfg.expert_share else E
    counts = flat.new_zeros(bins).scatter_add_(0, flat, torch.ones_like(flat))
    xs = x[order // k]
    # a token picks an expert once, so no segment is longer than T
    ys = segments_grouped(xs, counts[:E], p["w_gate"], p["w_up"], p["w_down"], T)
    if cfg.expert_share:
        # the rows past the held pairs went through no product
        ys = torch.where((flat[order] < E)[:, None], ys, 0.0)
        aux["held_pairs"] = T * k - counts[E]
    y = torch.empty_like(ys)
    y[order] = ys  # back to (token, pick) order
    out = (y.view(T, k, D) * weights.to(x.dtype)[..., None]).sum(1)
    aux["dropped"] = torch.zeros((), dtype=torch.int64, device=x.device)
    return out, aux


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
    """The MoE FFN's leaves: the router over all `n_router` experts (and
    the sigmoid router's bias), the held experts' weights, the shared
    expert's."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {
        "router": (D, cfg.n_router),
        "w_gate": (E, D, F_),
        "w_up": (E, D, F_),
        "w_down": (E, F_, D),
    }
    if cfg.router_scoring == "sigmoid":
        s["router_bias"] = (cfg.n_router,)
    if cfg.shared_d_ff:
        Fs = cfg.shared_d_ff
        s.update({"shared_gate": (D, Fs), "shared_up": (D, Fs), "shared_down": (Fs, D)})
    return s
