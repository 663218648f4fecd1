"""Multi-pod dry run: every (architecture x input shape) step runs sharded on
the production meshes (16x16 single-pod and 2x16x16 multi-pod) on meta
tensors, with no device memory, under a fake process group of 256 or 512
ranks (this process is rank 0). Counterpart of `repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-moe-235b-a22b --both-meshes

Decode shapes run `decode_step` (one token against a seq_len KV cache);
prefill runs the cache-producing `prefill_forward`, its cache brought to
the decode-cache layout; train runs `loss_fn` and its backward pass and an
AdamW update. long_500k uses the sliding-window serving variant for
full-attention archs (`config_for_shape`). Each record carries the
parameter/optimizer/cache bytes a device holds under the sharding rules
(the reference's arithmetic, so the same numbers), the per-rank FLOPs,
bytes and collective bytes of the step (`op_analysis`), and its H100
roofline (`roofline`).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, Iterator

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, INPUT_SHAPES, InputShape, ModelConfig, config_for_shape, get_config
from ..models import abstract_params, cache_shapes, decode_step, loss_fn, prefill_forward
from ..sharding.ctx import activation_sharding
from ..sharding.rules import (MeshLike, Spec, axis_sizes, batch_axes, cache_partition_specs,
                              local_shape, opt_state_specs, param_partition_specs, placements,
                              shard_local)
from ..training.optimizer import AdamWConfig, adamw_update
from ..training.tree import named_leaves, tree_map
from .mesh import make_production_mesh
from .op_analysis import analyze_ops
from .roofline import HBM_BYTES, analyze

MESHES = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


def _abstract_opt_state(params: Any) -> Dict[str, Any]:
    f32 = lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta")  # noqa: E731
    return {"m": tree_map(f32, params), "v": tree_map(f32, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _map2(fn, tree: Any, specs: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def _divisible_batch_spec(mesh: MeshLike, B: int) -> Spec:
    """Batch over (pod, data), dropping leading axes until B divides."""
    sizes = axis_sizes(mesh)
    axes = list(batch_axes(sizes))
    while axes:
        total = 1
        for a in axes:
            total *= sizes[a]
        if B % total == 0:
            return (tuple(axes) if len(axes) > 1 else axes[0],)
        axes.pop(0)
    return ()


def input_specs(arch: str, shape_name: str, mesh: MeshLike) -> Dict[str, Any]:
    """Meta-tensor stand-ins (global shapes, no allocation) for every model
    input of the (arch, shape) workload, with the spec of each: "params"/
    "pspecs", and "batch" + "opt_state"/"ospecs" (train), "tokens" (+
    "enc_frames") (prefill), or "cache"/"cspecs", "token" and "pos"
    (decode); "bspec" is the batch inputs' spec."""
    shape = INPUT_SHAPES[shape_name]
    cfg = config_for_shape(get_config(arch), shape)
    params = abstract_params(cfg)
    pspecs = param_partition_specs(cfg, mesh, params)
    B, S = shape.global_batch, shape.seq_len
    tok = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")  # noqa: E731
    frames = lambda: torch.empty((B, S // 4, cfg.d_model), dtype=torch.bfloat16,  # noqa: E731
                                 device="meta")
    out: Dict[str, Any] = {"cfg": cfg, "params": params, "pspecs": pspecs,
                           "bspec": _divisible_batch_spec(mesh, B)}
    if shape.kind == "train":
        out["batch"] = {"tokens": tok(B, S), "targets": tok(B, S)}
        if cfg.is_encdec:
            out["batch"]["enc_frames"] = frames()
        out["opt_state"] = _abstract_opt_state(params)
        out["ospecs"] = opt_state_specs(pspecs)
    elif shape.kind == "prefill":
        out["tokens"] = tok(B, S)
        if cfg.is_encdec:
            out["enc_frames"] = frames()
    else:  # decode
        enc_len = 1024 if cfg.is_encdec else 0
        out["cache"] = cache_shapes(cfg, B, S, enc_len)
        out["cspecs"] = cache_partition_specs(cfg, mesh, out["cache"])
        out["token"] = tok(B, 1)
        out["pos"] = S - 1  # the last position of a full cache
    return out


def _analytic_bytes(arch: str, shape_name: str, mesh: MeshLike) -> int:
    """Parameter/optimizer/cache bytes per device implied by the shardings."""
    spec = input_specs(arch, shape_name, mesh)
    total = 0

    def add(tree, specs):
        nonlocal total
        for (_, t), (_, s) in zip(named_leaves(tree), named_leaves(specs), strict=True):
            n = 1
            for d in local_shape(tuple(t.shape), s, mesh):
                n *= d
            total += n * t.element_size()

    add(spec["params"], spec["pspecs"])
    if "opt_state" in spec:
        add(spec["opt_state"], spec["ospecs"])
    if "cache" in spec:
        add(spec["cache"], spec["cspecs"])
    return total


def _model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def _sharded(tree: Any, specs: Any, mesh, *, requires_grad: bool = False) -> Any:
    """Each meta leaf as a DTensor of its spec: a meta tensor of this rank's
    shard shape under the global shape."""
    def leaf(t, spec):
        local = torch.empty(local_shape(tuple(t.shape), spec, mesh), dtype=t.dtype, device="meta")
        return shard_local(local, spec, mesh).requires_grad_(requires_grad)

    return _map2(leaf, tree, specs)


def _step(spec: Dict[str, Any], shape: InputShape, mesh):
    """The step of `shape.kind` on the sharded stand-ins, as a thunk."""
    cfg = spec["cfg"]
    batched = lambda t: _sharded(t, spec["bspec"], mesh)  # noqa: E731
    if shape.kind == "train":
        params = _sharded(spec["params"], spec["pspecs"], mesh, requires_grad=True)
        opt_state = _sharded(spec["opt_state"], spec["ospecs"], mesh)
        batch = {k: batched(t) for k, t in spec["batch"].items()}

        def train_step():
            loss, aux = loss_fn(cfg, params, batch)
            loss.backward()
            grads = tree_map(lambda p: p.grad, params)
            return adamw_update(AdamWConfig(), params, grads, opt_state)

        return train_step
    params = _sharded(spec["params"], spec["pspecs"], mesh)
    if shape.kind == "prefill":
        cshapes = cache_shapes(cfg, shape.global_batch, shape.seq_len,
                               shape.seq_len // 4 if cfg.is_encdec else 0)
        cspecs = cache_partition_specs(cfg, mesh, cshapes)
        enc = {"enc_frames": batched(spec["enc_frames"])} if cfg.is_encdec else {}

        def prefill_step():
            with torch.no_grad():
                logits, cache = prefill_forward(cfg, params, batched(spec["tokens"]), **enc)
            # the decode-cache layout, as the reference's out_shardings give it
            return logits, {n: c.redistribute(mesh, placements(cspecs[n], mesh))
                            for n, c in cache.items()}

        return prefill_step
    cache = _sharded(spec["cache"], spec["cspecs"], mesh)

    def serve_step():
        with torch.no_grad():
            return decode_step(cfg, params, cache, batched(spec["token"]), spec["pos"])

    return serve_step


@contextlib.contextmanager
def fake_group(world_size: int) -> Iterator[None]:
    """A fake default process group of `world_size` ranks, this process rank
    0: collectives are accepted and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dry run: a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def case_stats(arch: str, shape_name: str, mesh):
    """The case's step on `mesh` under the counters: (cfg, OpStats)."""
    shape = INPUT_SHAPES[shape_name]
    spec = input_specs(arch, shape_name, mesh)
    cfg = spec["cfg"]
    loops = {"layers": cfg.num_layers}
    if cfg.is_encdec:
        loops["encoder_layers"] = cfg.encoder_layers
    with activation_sharding(mesh):
        _, stats = analyze_ops(_step(spec, shape, mesh), loops=loops)
    return cfg, stats


def run_case(arch: str, shape_name: str, *, multi_pod: bool) -> dict:
    """One case on its production mesh, under a fake group made for it; its
    tensors are meta tensors."""
    shape = INPUT_SHAPES[shape_name]
    sizes = MESHES[multi_pod]
    chips = math.prod(sizes.values())
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "kind": shape.kind,
    }
    t0 = time.perf_counter()
    with fake_group(chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        cfg, stats = case_stats(arch, shape_name, mesh)
    rec["seconds"] = time.perf_counter() - t0
    rec["analytic_bytes_per_device"] = _analytic_bytes(arch, shape_name, sizes)
    rec["fits_80GB"] = rec["analytic_bytes_per_device"] <= HBM_BYTES
    roof = analyze(stats, chips=chips, model_flops=_model_flops(cfg, shape))
    rec.update(flops=stats.flops, bytes=stats.bytes, collective_bytes=stats.collective_bytes,
               collectives=stats.collectives, loops=stats.loops, dot_count=stats.dot_count,
               roofline=roof.to_dict(), useful_ratio=roof.useful_ratio)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES),
                    help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh (512 ranks)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else [a.replace("_", "-") for a in ARCH_IDS]
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_case(arch, shape, multi_pod=mp)
                    r = rec["roofline"]
                    print(
                        f"OK   {tag}: {rec['seconds']:.2f}s | "
                        f"compute {r['compute_s']:.3e}s memory {r['memory_s']:.3e}s "
                        f"collective {r['collective_s']:.3e}s -> {r['bottleneck']} | "
                        f"useful {r['useful_ratio']:.2f} | "
                        f"bytes/dev {rec['analytic_bytes_per_device']}"
                    )
                except Exception as e:  # a failed case is reported and fails the run
                    failures += 1
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "error": traceback.format_exc()[-2000:]}
                    print(f"FAIL {tag}: {type(e).__name__}: {e}")
                    print(rec["error"], file=sys.stderr)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                sys.stdout.flush()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
