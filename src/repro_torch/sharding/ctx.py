"""Activation-sharding context.

Counterpart of `repro.sharding.ctx`. Model code is mesh-agnostic; the
launcher activates this context and the model's `constrain(x, kind)` calls
become DTensor redistributions that pin activations to the megatron-style
layout (batch over data axes, hidden "wide" dims over model). Without them
DTensor's sharding propagation is free to all-gather full-batch activations
against FSDP-sharded weights.

The context also enters `implicit_replication()`, so that the model's own
plain tensors (RoPE tables, masks, positions) join the DTensors as
replicated. Without an active context, or for a tensor that is not a
DTensor, `constrain` is the identity.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from .rules import Spec, axis_sizes, placements

_state = threading.local()


def _cur() -> Optional[dict]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def activation_sharding(mesh: DeviceMesh, *, enabled: bool = True) -> Iterator[None]:
    """Enable activation constraints for everything run inside. `enabled=False`
    keeps the mesh (and implicit replication) but makes `constrain` and
    `moe_ffn_ep` act as without a mesh."""
    sizes = axis_sizes(mesh)
    batch = tuple(a for a in ("pod", "data") if a in sizes)
    prev = _cur()
    _state.ctx = {
        "mesh": mesh,
        "sizes": sizes,
        "batch": batch if len(batch) != 1 else batch[0],
        "model": "model" if "model" in sizes else None,
        "enabled": enabled,
    }
    try:
        with implicit_replication():
            yield
    finally:
        _state.ctx = prev


def rule(kind: str, shape: tuple, ctx: dict) -> Spec:
    """The spec of layout rule `kind` for a tensor of `shape` under `ctx`,
    with the axes that don't divide their dim dropped.

    kinds:
      bsd      (B, S, D) residual stream        -> (batch, None, None)
      bsf      (B, S, F) ffn/inner hidden       -> (batch, None, model)
      bshd     (B, S, H, hd) attention heads    -> (batch, None, model, None)
      bhst     (B, H, S, T) attention scores    -> (batch, model, None, None)
      logits   (B, S, V) or (B, V)              -> (batch, ..., model)
      ecd      (E, C, D) expert buckets         -> (model, None, None)
      lbskd    (L, B, W, K, hd) kv cache blocks -> (None, batch, None, model, None)
      cache_kv (B, W, K, hd) decode-cache block -> K over model, else W, else neither
    """
    b, m = ctx["batch"], ctx["model"]
    sizes = ctx["sizes"]
    if kind == "bsd":
        spec = (b, None, None)
    elif kind == "bsf":
        spec = (b, None, m)
    elif kind == "bshd":
        spec = (b, None, m, None)
    elif kind == "logits":
        spec = (b,) + (None,) * (len(shape) - 2) + (m,)
    elif kind == "ecd":
        spec = (m, None, None)
    elif kind == "bhst":
        spec = (b, m, None, None)
    elif kind == "lbskd":
        spec = (None, b, None, m, None)
    elif kind == "cache_kv":
        # prefer sharding KV heads over model; MQA/GQA below mesh size shard
        # the length instead (mirrors rules.cache_partition_specs)
        msize = sizes[m] if m is not None else 1
        if m is not None and shape[2] % msize == 0:
            spec = (b, None, m, None)
        elif m is not None and shape[1] % msize == 0:
            spec = (b, m, None, None)
        else:
            spec = (b, None, None, None)
    else:
        raise ValueError(f"unknown constraint kind {kind!r}")

    # divisibility guard: drop axes that don't divide
    def ok(axis, dim):
        if axis is None:
            return None
        axes = axis if isinstance(axis, tuple) else (axis,)
        return axis if dim % math.prod(sizes[a] for a in axes) == 0 else None

    return tuple(ok(a, d) for a, d in zip(spec, shape))


class _Constrain(torch.autograd.Function):
    """Redistribute to `want` in both directions: the gradient is pinned to
    the activation's layout, as the transpose of the reference's sharding
    constraint pins the cotangent (a plain `redistribute` would send the
    gradient back in whatever layout it arrives)."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return x.redistribute(mesh, want) if tuple(x.placements) != want else x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.want), None, None


def constrain(x, kind: str):
    """Redistribute the DTensor `x` (and, under autograd, its gradient) to
    the layout rule `kind` if a sharding context is active; otherwise
    return `x` as it is."""
    ctx = _cur()
    if ctx is None or not ctx["enabled"] or not isinstance(x, DTensor):
        return x
    want = placements(rule(kind, tuple(x.shape), ctx), ctx["mesh"])
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x if tuple(x.placements) == want else x.redistribute(ctx["mesh"], want)
    return _Constrain.apply(x, ctx["mesh"], want)


def hold_layout(x):
    """x, with its gradient brought to x's own layout before it flows on
    (a DTensor under autograd; anything else as it is): for an op whose
    backward cannot take the layout the gradient arrives in."""
    if isinstance(x, DTensor) and torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, x.device_mesh, tuple(x.placements))
    return x


def split_dim(x, dim: int, *sizes: int):
    """x with dim `dim` split into `sizes` (a reshape). A DTensor whose dim
    is sharded over more ranks than `sizes[0]` splits into is first
    gathered over them (as XLA reshards a dim it cannot split), so a head
    split stays exact."""
    dim %= x.ndim
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        n = math.prod(mesh.size(i) for i, p in enumerate(x.placements) if p.is_shard(dim))
        if sizes[0] % n:
            x = x.redistribute(mesh, [Replicate() if p.is_shard(dim) else p
                                      for p in x.placements])
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])
