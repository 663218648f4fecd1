"""Per-rank op accounting -- the dry run's "profiler".

Counterpart of `src/repro/launch/hlo_analysis.py`. There is no HLO in
torch: the step runs eagerly (on meta tensors in the dry run), and a
dispatch mode sees every aten op it issues. DTensor ops are let through to
their sharding rules first (the mode returns NotImplemented for them, as
`CommDebugMode` does), and the ops DTensor runs on fake tensors of the
global shapes to propagate shardings are left out, so what is counted is
each rank's local program, the per-chip view the reference's HLO gives:

  * FLOPs: `torch.utils.flop_counter`'s formulas (the ones `FlopCounterMode`
    uses) over the local ops; matrix products and attention kernels count,
    elementwise work does not, as in the reference's dot-only count;
  * bytes: operand and result bytes of every local op that is not a view,
    a bare allocation or a collective's wait.
    XLA's count stops at fusion boundaries; eager torch has none, so this is
    an unfused upper bound on HBM traffic, not the reference's number;
  * collectives: the functional collectives DTensor issues, counted by
    `torch.distributed.tensor.debug.CommDebugMode`, and their result bytes
    (the reference's convention), per kind;
  * loops: the Python loops' trip counts, as the caller states them (the
    layers run as a Python loop, each counted as it runs).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

_c10d = torch.ops._c10d_functional
# the functional collectives DTensor issues -> the reference's HLO names
COLLECTIVES = {
    _c10d.all_gather_into_tensor: "all-gather",
    _c10d.all_gather_into_tensor_coalesced: "all-gather",
    _c10d.all_reduce: "all-reduce",
    _c10d.all_reduce_coalesced: "all-reduce",
    _c10d.reduce_scatter_tensor: "reduce-scatter",
    _c10d.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _c10d.all_to_all_single: "all-to-all",
    _c10d.broadcast: "collective-permute",
    torch.ops._dtensor.shard_dim_alltoall: "all-to-all",
}


# ops that move no bytes: bare allocations, and the functional collectives'
# wrappers and waits (the collective itself is counted)
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
               _c10d.wait_tensor, _c10d._wrap_tensor_autograd}


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    loops: Dict[str, int] = dataclasses.field(default_factory=dict)
    dot_count: float = 0.0

    def add_collective(self, base: str, nbytes: float) -> None:
        d = self.collectives.setdefault(base, {"count": 0.0, "bytes": 0.0})
        d["count"] += 1
        d["bytes"] += nbytes
        self.collective_bytes += nbytes


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    def __init__(self, stats: OpStats):
        super().__init__()
        self.stats = stats
        self.formulas = FlopCounterMode(display=False).flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor first: its local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out  # DTensor's sharding propagation on global shapes, not run by a rank
        packet = func._overloadpacket
        if packet in COLLECTIVES:
            self.stats.add_collective(COLLECTIVES[packet], _nbytes(out))
        formula = self.formulas.get(packet)
        if formula is not None:
            self.stats.flops += formula(*args, **kwargs, out_val=out)
            self.stats.dot_count += 1
        if not func.is_view and packet not in _NO_TRAFFIC:
            self.stats.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def analyze_ops(fn: Callable[..., Any], *args, loops: Optional[Dict[str, int]] = None,
                **kwargs) -> tuple:
    """Run fn(*args, **kwargs) once under the counters. Returns (its result,
    OpStats). The collective counts are `CommDebugMode`'s and must agree
    with the mode's own."""
    # imported here: importing it sets TORCHINDUCTOR_CACHE_DIR, and importing
    # the port sets no environment variable
    from torch.distributed.tensor.debug import CommDebugMode

    stats = OpStats(loops=dict(loops or {}))
    with CommDebugMode() as comm, _Counter(stats):
        out = fn(*args, **kwargs)
    counted: Dict[str, float] = {}
    for op, n in comm.get_comm_counts().items():
        base = {packet.__name__: name for packet, name in COLLECTIVES.items()}.get(op.__name__)
        if base is None:
            raise RuntimeError(f"op_analysis: CommDebugMode counted {op}, which has no kind here")
        counted[base] = counted.get(base, 0) + n
    mine = {k: v["count"] for k, v in stats.collectives.items()}
    if counted != mine:
        raise RuntimeError(f"op_analysis: collectives {mine} against CommDebugMode's {counted}")
    return out, stats
