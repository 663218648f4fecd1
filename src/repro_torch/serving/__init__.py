"""Serving over the TENT engine. Only prefill/decode disaggregation is
ported so far; the host-side serving simulator comes with a later slice."""
from .disagg import (
    DisaggregatedServer,
    DisaggResult,
    bytes_to_tree,
    greedy_decode,
    monolithic_generate,
    tree_to_bytes,
)

__all__ = [
    "DisaggregatedServer", "DisaggResult", "bytes_to_tree", "greedy_decode",
    "monolithic_generate", "tree_to_bytes",
]
