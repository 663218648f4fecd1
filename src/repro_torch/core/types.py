"""Core value types for the TENT data-movement engine.

The vocabulary here mirrors the paper (§3): *segments* name data, *slices*
are the unit of scheduling and isolation, *batches* are the unit of
application-visible completion.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional

# ---------------------------------------------------------------------------
# Identifiers
# ---------------------------------------------------------------------------

_batch_ids = itertools.count(1)
_slice_ids = itertools.count(1)
_transfer_ids = itertools.count(1)


def next_batch_id() -> int:
    return next(_batch_ids)


def next_slice_id() -> int:
    return next(_slice_ids)


def next_transfer_id() -> int:
    return next(_transfer_ids)


class MemoryKind(enum.Enum):
    """Where a segment's bytes physically live (paper Fig. 4)."""

    HOST_DRAM = "host_dram"
    DEVICE_HBM = "device_hbm"
    FILE = "file"  # SSD / NVMe-oF via io_uring-style backend


class LinkClass(enum.Enum):
    """Physical interconnect classes unified by TENT (paper Fig. 1)."""

    RDMA = "rdma"  # multi-rail RoCE / IB NICs
    NVLINK = "nvlink"  # intra-node GPU-GPU
    MNNVL = "mnnvl"  # rack-scale multi-node NVLink
    PCIE = "pcie"  # host<->device staging hops
    TCP = "tcp"  # fallback
    SHM = "shm"  # intra-node host-host
    STORAGE = "storage"  # NVMe / io_uring lanes
    UB = "ub"  # Ascend unified bus (portability target)


@dataclasses.dataclass(frozen=True)
class Location:
    """Physical placement of a buffer: node, device, NUMA domain."""

    node: int
    kind: MemoryKind
    device: int = 0  # GPU ordinal for HBM, socket for DRAM, lun for FILE
    numa: int = 0

    def same_node(self, other: "Location") -> bool:
        return self.node == other.node


@dataclasses.dataclass(frozen=True)
class TransferRequest:
    """One entry of a declarative BatchTransfer: pure intent, no bindings."""

    transfer_id: int
    src_segment: int
    src_offset: int
    dst_segment: int
    dst_offset: int
    length: int

    def __post_init__(self) -> None:
        if self.length <= 0:
            raise ValueError(f"transfer length must be positive, got {self.length}")
        if self.src_offset < 0 or self.dst_offset < 0:
            raise ValueError("offsets must be non-negative")


class SliceState(enum.Enum):
    PENDING = "pending"
    INFLIGHT = "inflight"
    DONE = "done"
    FAILED = "failed"


@dataclasses.dataclass(slots=True)
class Slice:
    """Unit of scheduling/isolation. Writes to an *absolute* destination
    offset so re-execution is idempotent (paper §4.3)."""

    slice_id: int
    transfer_id: int
    batch_id: int
    src_segment: int
    src_offset: int
    dst_segment: int
    dst_offset: int
    length: int
    # --- execution state ---
    state: SliceState = SliceState.PENDING
    attempts: int = 0
    hop: int = 0  # current hop index for staged routes
    route_idx: int = 0  # which plan option this slice was issued on
    submitted_at: float = 0.0
    scheduled_link: Optional[int] = None
    completed_at: float = 0.0


class BatchState(enum.Enum):
    OPEN = "open"
    SUBMITTED = "submitted"
    DONE = "done"
    FAILED = "failed"


@dataclasses.dataclass
class TentError(Exception):
    code: str
    detail: str = ""

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        return f"TentError({self.code}: {self.detail})"


NO_ELIGIBLE_DEVICE = "NoEligibleDevice"
UNREACHABLE = "Unreachable"
EXHAUSTED_RETRIES = "ExhaustedRetries"
