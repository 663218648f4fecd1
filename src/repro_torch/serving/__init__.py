"""Serving over the TENT engine: prefill/decode disaggregation of a real
model (`disagg`), and the host-side layers carried over from
`repro.serving`: the paged KV pools and HiCache tiering, the checkpoint
engine, the roofline/table performance model, P-squared percentile
sketches and the serving simulator."""
from .checkpoint_engine import CheckpointEngine, UpdateResult
from .disagg import (
    DisaggregatedServer,
    DisaggResult,
    bytes_to_tree,
    greedy_decode,
    monolithic_generate,
    tree_to_bytes,
)
from .hicache import FetchResult, HiCache
from .kvcache import PagePool, kv_bytes_per_token, make_cpu_pool, make_disk_pool, make_gpu_pool
from .perf_model import PerfModel, from_roofline, from_table2
from .serve_sim import Request, RequestTable, ServeSimConfig, ServeStats, ServingSimulator
from .sketch import P2Quantile, PercentileSketch

__all__ = [
    "CheckpointEngine", "UpdateResult", "DisaggregatedServer", "DisaggResult",
    "bytes_to_tree", "greedy_decode", "monolithic_generate", "tree_to_bytes",
    "FetchResult", "HiCache", "PagePool",
    "kv_bytes_per_token", "make_cpu_pool", "make_disk_pool", "make_gpu_pool",
    "PerfModel", "from_roofline", "from_table2", "ServeSimConfig",
    "ServeStats", "ServingSimulator", "Request", "RequestTable",
    "P2Quantile", "PercentileSketch",
]
