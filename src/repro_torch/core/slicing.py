"""Slice decomposition (paper §4.2 "Slice Decomposition").

Elephant flows are split into slices with a configurable minimum size (64 KB
by default): small enough that no slice holds a rail for long (HoL
mitigation), large enough to amortize enqueue/completion costs. For extremely
large requests the total slice count is capped to bound control-plane
overhead. Every slice carries an *absolute* destination offset so that
out-of-order completion and idempotent re-execution need no CPU-side
reordering (paper §4.3 / §4.4).
"""
from __future__ import annotations

from typing import List

from .types import Slice, TransferRequest, next_slice_id

DEFAULT_SLICE_BYTES = 64 * 1024
DEFAULT_MAX_SLICES = 512


def decompose(
    req: TransferRequest,
    batch_id: int,
    *,
    slice_bytes: int = DEFAULT_SLICE_BYTES,
    max_slices: int = DEFAULT_MAX_SLICES,
) -> List[Slice]:
    """Split one declarative transfer into scheduling slices.

    Invariants (property-tested): slices tile [0, length) exactly, without
    overlap, preserving the src->dst offset correspondence; every slice is
    at least `slice_bytes` long except possibly when length < slice_bytes;
    at most `max_slices` slices are produced.
    """
    if slice_bytes <= 0:
        raise ValueError("slice_bytes must be positive")
    if max_slices <= 0:
        raise ValueError("max_slices must be positive")
    length = req.length
    n = min(max(1, length // slice_bytes), max_slices)
    base = length // n
    rem = length % n
    transfer_id, src_segment, dst_segment = req.transfer_id, req.src_segment, req.dst_segment
    src_base, dst_base = req.src_offset, req.dst_offset
    slices: List[Slice] = []
    append = slices.append
    off = 0
    for i in range(n):
        ln = base + (1 if i < rem else 0)
        append(Slice(next_slice_id(), transfer_id, batch_id,
                     src_segment, src_base + off, dst_segment, dst_base + off, ln))
        off += ln
    assert off == length
    return slices
