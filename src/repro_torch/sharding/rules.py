"""Sharding rules: logical parameter/activation axes -> mesh axes.

Counterpart of `repro.sharding.rules`. A spec is the reference's
`PartitionSpec` as a plain tuple with one entry per tensor dim: None,
a mesh axis name ("model"), or a tuple of names (("pod", "data")), the
last for a dim split over several axes, major first. `()` replicates
everything. `placements` turns a spec into DTensor placements on a
`DeviceMesh`.

Policy (the reference's):

  * weights are 2-D sharded: the "wide" axis (heads / ffn / experts / vocab)
    over `model`, the d_model (or stacked) axis over `data` (FSDP-style) --
    so even the 132B/235B configs fit an 80 GB card with optimizer state;
  * batch shards over (`pod`, `data`); sequence stays unsharded (decode KV
    ring buffers and SSD chunk scans keep locality);
  * KV heads shard over `model` only when divisible (granite's MQA kv=1
    replicates); MoE experts shard over `model` (expert parallelism);
  * optimizer moments follow their parameters.

An axis is dropped (replicated) whenever its size doesn't divide the mesh
axis, so every shard of every tensor has the same shape.

A mesh here is a `DeviceMesh` with named dims, or a plain mapping from axis
name to size: the rules read only the sizes, as the reference's read only
`mesh.shape`, so they run on a mapping without a process group.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from ..configs.base import ModelConfig

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]
MeshLike = Union[DeviceMesh, Mapping[str, int]]


def axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    """{axis name: size} of a named DeviceMesh or of a mapping."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("the sharding rules need a DeviceMesh with named dims")
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def _div(n: int, sizes: Mapping[str, int], axis: Optional[str]) -> bool:
    return axis is not None and axis in sizes and n % sizes[axis] == 0


def _maybe(axis: Optional[str], size: int, sizes: Mapping[str, int]) -> Optional[str]:
    return axis if _div(size, sizes, axis) else None


def batch_axes(mesh: MeshLike) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _wide_spec(shape: tuple, sizes: Mapping[str, int], *, wide_axis: int,
               fsdp_axis: Optional[int], fsdp: bool) -> Spec:
    """Shard shape[wide_axis] over model, shape[fsdp_axis] over data."""
    spec: List[Axis] = [None] * len(shape)
    if _div(shape[wide_axis], sizes, "model"):
        spec[wide_axis] = "model"
    if fsdp and fsdp_axis is not None and _div(shape[fsdp_axis], sizes, "data"):
        spec[fsdp_axis] = "data"
    return tuple(spec)


def param_partition_specs(cfg: ModelConfig, mesh: MeshLike, shapes: Dict[str, Any], *,
                          fsdp: bool = True) -> Dict[str, Any]:
    """Spec tree matching `param_shapes(cfg)`'s structure (leaves: shape
    tuples, or tensors, whose `.shape` is read)."""
    sizes = axis_sizes(mesh)

    def leaf_spec(name: str, shape: tuple) -> Spec:
        nd = len(shape)
        # embeddings / lm head: vocab over model, d_model over data
        if name == "embed":
            return _wide_spec(shape, sizes, wide_axis=0, fsdp_axis=1, fsdp=fsdp)
        if name == "lm_head":
            return _wide_spec(shape, sizes, wide_axis=1, fsdp_axis=0, fsdp=fsdp)
        # stacked layer tensors: axis 0 = layer (never sharded)
        if name in ("ln1", "ln2", "lnx", "final_norm", "ssm_norm", "ssm_A_log",
                    "ssm_D", "ssm_dt_bias", "ssm_conv_b", "bq", "bk", "bv", "ssm_conv_w"):
            return ()
        if name in ("wq", "wk", "wv", "xwq", "xwk", "xwv"):  # (L, D, heads*hd)
            return _wide_spec(shape, sizes, wide_axis=nd - 1, fsdp_axis=nd - 2, fsdp=fsdp)
        if name in ("wo", "xwo"):  # (L, heads*hd, D)
            return _wide_spec(shape, sizes, wide_axis=nd - 2, fsdp_axis=nd - 1, fsdp=fsdp)
        if name == "router":  # (L, D, E): replicate E (tiny), fsdp D
            spec: List[Axis] = [None] * nd
            if fsdp and _div(shape[nd - 2], sizes, "data"):
                spec[nd - 2] = "data"
            return tuple(spec)
        if name in ("w_gate", "w_up"):
            if cfg.num_experts > 0 and nd == 4:  # (L, E, D, F): expert parallel
                return _wide_spec(shape, sizes, wide_axis=1, fsdp_axis=3, fsdp=fsdp)
            return _wide_spec(shape, sizes, wide_axis=nd - 1, fsdp_axis=nd - 2, fsdp=fsdp)
        if name == "w_down":
            if cfg.num_experts > 0 and nd == 4:  # (L, E, F, D)
                return _wide_spec(shape, sizes, wide_axis=1, fsdp_axis=2, fsdp=fsdp)
            return _wide_spec(shape, sizes, wide_axis=nd - 2, fsdp_axis=nd - 1, fsdp=fsdp)
        if name == "ssm_in":  # (L, D, 2di+2N+nh): inner dim over model
            return _wide_spec(shape, sizes, wide_axis=nd - 1, fsdp_axis=nd - 2, fsdp=fsdp)
        if name == "ssm_out":  # (L, di, D)
            return _wide_spec(shape, sizes, wide_axis=nd - 2, fsdp_axis=nd - 1, fsdp=fsdp)
        return ()

    def walk(tree: Any, name: str = "") -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return leaf_spec(name, tuple(getattr(tree, "shape", tree)))

    return walk(shapes)


def param_shardings(cfg: ModelConfig, mesh: DeviceMesh, shapes: Dict[str, Any], *,
                    fsdp: bool = True) -> Dict[str, Any]:
    """DTensor placements on `mesh` for every leaf of `shapes`."""
    specs = param_partition_specs(cfg, mesh, shapes, fsdp=fsdp)
    return _tree_map(lambda spec: placements(spec, mesh), specs)


def batch_spec(mesh: MeshLike) -> Spec:
    axes = batch_axes(mesh)
    return (axes if len(axes) > 1 else (axes[0] if axes else None),)


def cache_partition_specs(cfg: ModelConfig, mesh: MeshLike,
                          cache_shapes: Dict[str, Any]) -> Dict[str, Spec]:
    """Decode cache: (L, B, ...) -- batch over (pod, data), kv-heads/ssm-heads
    over model when divisible."""
    sizes = axis_sizes(mesh)
    baxes = batch_axes(sizes)
    out: Dict[str, Spec] = {}
    for name, leaf in cache_shapes.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        B = shape[1]
        bshard: Axis = baxes if B % math.prod(sizes[a] for a in baxes) == 0 else (
            baxes[-1] if baxes and B % sizes[baxes[-1]] == 0 else None)
        if isinstance(bshard, tuple) and len(bshard) == 1:
            bshard = bshard[0]  # a one-axis tuple is that axis, as PartitionSpec has it
        b = bshard if bshard else None
        if name in ("k", "v", "enc_k", "enc_v"):  # (L, B, W, K, Hd)
            kv = _maybe("model", shape[3], sizes)
            # MQA/GQA with kv_heads < mesh: shard the cache LENGTH instead --
            # keeps e.g. granite's kv=1 32k cache at W/16 per card.
            wshard = "model" if kv is None and _div(shape[2], sizes, "model") else None
            out[name] = (None, b, wshard, kv, None)
        elif name == "ssm_state":  # (L, B, nh, hd, N)
            out[name] = (None, b, _maybe("model", shape[2], sizes), None, None)
        elif name == "conv_buf":  # (L, B, k-1, dim)
            out[name] = (None, b, None, _maybe("model", shape[3], sizes))
        else:
            out[name] = ()
    return out


def opt_state_specs(param_specs: Dict[str, Any]) -> Dict[str, Any]:
    return {"m": param_specs, "v": param_specs, "step": ()}


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh
# ---------------------------------------------------------------------------

def _names(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """DTensor placements of `spec` on `mesh`: mesh dim i gets Shard(d) for
    the tensor dim d whose entry names it, Replicate() otherwise. A dim
    split over several axes must name them in the mesh's order (major
    first), which is the order DTensor splits in."""
    names = list(axis_sizes(mesh))
    out: List[Placement] = [Replicate()] * len(names)
    for d, axis in enumerate(spec):
        axes = _names(axis)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shape(shape: tuple, spec: Spec, mesh: MeshLike) -> Tuple[int, ...]:
    """One shard's shape, as the reference's `NamedSharding.shard_shape`
    gives it: each dim divided (rounded up) by the sizes of its axes."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, axis in enumerate(spec):
        out[d] = -(-shape[d] // math.prod(sizes[a] for a in _names(axis)))
    return tuple(out)


def shard_local(t: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> DTensor:
    """`t` (this rank's shard, or a meta tensor of its shape) as a DTensor of
    the global shape `spec` implies. `t` must have `local_shape`'s shape."""
    sizes = axis_sizes(mesh)
    gshape = list(t.shape)
    for d, axis in enumerate(spec):
        gshape[d] *= math.prod(sizes[a] for a in _names(axis))
    return DTensor.from_local(t, mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(gshape),
                              stride=torch.empty(gshape, device="meta").stride())


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
