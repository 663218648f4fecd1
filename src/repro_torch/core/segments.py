"""Segment abstraction (paper §3.1).

A segment is a logical data region mapped to one or more contiguous buffers,
independent of the storage medium. Applications interact exclusively with
segment identifiers, offsets, and lengths. Internally each segment carries
device-specific metadata (RDMA keys, GPU handles, file descriptors) in a
normalized structure that only the owning backend interprets.

In this reproduction buffers are numpy byte arrays so that transfers move
*real bytes* and data integrity is testable end to end.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional

import numpy as np

from .types import Location, MemoryKind

_segment_ids = itertools.count(1)


@dataclasses.dataclass
class Buffer:
    """One contiguous region backing (part of) a segment."""

    start: int  # offset of this buffer within the segment
    length: int
    data: np.ndarray  # uint8 view; the actual bytes

    def __post_init__(self) -> None:
        assert self.data.dtype == np.uint8
        assert self.data.size == self.length


@dataclasses.dataclass
class Segment:
    """A logical, transport-agnostic data region (paper Fig. 4)."""

    segment_id: int
    location: Location
    buffers: List[Buffer]
    # Normalized per-backend metadata: backend name -> opaque dict.
    # e.g. {"rdma": {"rkey": ..., "registered_nics": [...]}, "nvlink": {...}}
    backend_metadata: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # Transport capabilities derived from topology at registration time.
    transports: List[str] = dataclasses.field(default_factory=list)
    name: str = ""
    # Phantom segments carry timing/bookkeeping but no backing bytes — used
    # by large-scale simulations where allocating the real pool (tens of GB)
    # is pointless. Data-integrity tests always use materialized segments.
    phantom_length: int = 0

    @property
    def phantom(self) -> bool:
        return self.phantom_length > 0

    @property
    def length(self) -> int:
        if self.phantom:
            return self.phantom_length
        return sum(b.length for b in self.buffers)

    # -- byte access (used by transport backends only; the core engine and
    # applications never touch raw bytes) ----------------------------------
    def read(self, offset: int, length: int) -> np.ndarray:
        self._check_range(offset, length)
        if self.phantom:
            return np.zeros(length, dtype=np.uint8)
        out = np.empty(length, dtype=np.uint8)
        done = 0
        for buf in self.buffers:
            lo = max(offset, buf.start)
            hi = min(offset + length, buf.start + buf.length)
            if lo < hi:
                out[lo - offset : hi - offset] = buf.data[lo - buf.start : hi - buf.start]
                done += hi - lo
        assert done == length
        return out

    def write(self, offset: int, payload: np.ndarray) -> None:
        length = payload.size
        self._check_range(offset, length)
        if self.phantom:
            return
        for buf in self.buffers:
            lo = max(offset, buf.start)
            hi = min(offset + length, buf.start + buf.length)
            if lo < hi:
                buf.data[lo - buf.start : hi - buf.start] = payload[lo - offset : hi - offset]

    def _check_range(self, offset: int, length: int) -> None:
        if offset < 0 or offset + length > self.length:
            raise IndexError(
                f"segment {self.segment_id}: range [{offset}, {offset + length}) "
                f"out of bounds (len={self.length})"
            )


class SegmentManager:
    """Registry of segments plus their metadata lifecycle (paper §3.1).

    The manager is the "global ground truth" consulted by the orchestrator:
    where data resides and which transports remain available. Remote metadata
    retrieval is modelled by the registry being cluster-global (the paper's
    engine fetches it on demand over the control plane).
    """

    def __init__(self) -> None:
        self._segments: Dict[int, Segment] = {}

    def register(
        self,
        location: Location,
        length: int,
        *,
        name: str = "",
        n_buffers: int = 1,
        init: Optional[np.ndarray] = None,
        materialize: bool = True,
    ) -> Segment:
        if length <= 0:
            raise ValueError("segment length must be positive")
        if n_buffers < 1 or n_buffers > length:
            raise ValueError("bad buffer count")
        seg_id = next(_segment_ids)
        if not materialize:
            seg = Segment(segment_id=seg_id, location=location, buffers=[],
                          name=name, phantom_length=length)
            self._segments[seg_id] = seg
            return seg
        buffers: List[Buffer] = []
        # Split into roughly equal contiguous buffers (multi-buffer segments
        # model e.g. per-layer KV page groups registered together).
        base = length // n_buffers
        start = 0
        for i in range(n_buffers):
            blen = base + (length - base * n_buffers if i == n_buffers - 1 else 0)
            data = np.zeros(blen, dtype=np.uint8)
            if init is not None:
                data[:] = init[start : start + blen]
            buffers.append(Buffer(start=start, length=blen, data=data))
            start += blen
        seg = Segment(segment_id=seg_id, location=location, buffers=buffers, name=name)
        self._segments[seg_id] = seg
        return seg

    def deregister(self, segment_id: int) -> None:
        self._segments.pop(segment_id, None)

    def get(self, segment_id: int) -> Segment:
        try:
            return self._segments[segment_id]
        except KeyError:
            raise KeyError(f"unknown segment {segment_id}") from None

    def attach_metadata(self, segment_id: int, backend: str, meta: dict) -> None:
        self.get(segment_id).backend_metadata[backend] = meta

    def set_transports(self, segment_id: int, transports: List[str]) -> None:
        self.get(segment_id).transports = list(transports)

    def all_segments(self) -> List[Segment]:
        return list(self._segments.values())


def host_segment(mgr: SegmentManager, node: int, length: int, *, numa: int = 0, name: str = "") -> Segment:
    return mgr.register(Location(node=node, kind=MemoryKind.HOST_DRAM, device=numa, numa=numa), length, name=name)


def device_segment(mgr: SegmentManager, node: int, gpu: int, length: int, *, numa: int = 0, name: str = "") -> Segment:
    return mgr.register(Location(node=node, kind=MemoryKind.DEVICE_HBM, device=gpu, numa=numa), length, name=name)


def file_segment(mgr: SegmentManager, node: int, length: int, *, name: str = "") -> Segment:
    return mgr.register(Location(node=node, kind=MemoryKind.FILE, device=0, numa=0), length, name=name)
