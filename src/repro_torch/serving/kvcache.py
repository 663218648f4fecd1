"""Paged KV cache bookkeeping over TENT segments.

A *page* holds `page_tokens` tokens' worth of K/V for every layer of one
model. Pools exist per tier (GPU HBM / CPU DRAM / disk); each pool is one
registered TENT segment plus a free-list, so moving a page between tiers is
exactly one declarative transfer — the engine decides rails/slices/staging.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..configs.base import ModelConfig
from ..core import Location, MemoryKind, TentEngine
from ..core.segments import Segment


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """2 (K and V) x layers x kv_heads x head_dim x 2 bytes (bf16)."""
    if cfg.attention_free:
        return 0
    return 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim * 2


@dataclasses.dataclass
class Page:
    page_id: int
    pool: "PagePool"
    offset: int  # byte offset within the pool segment

    @property
    def nbytes(self) -> int:
        return self.pool.page_bytes


class PagePool:
    """Fixed-size page allocator over one TENT segment."""

    def __init__(
        self,
        engine: TentEngine,
        location: Location,
        *,
        page_bytes: int,
        num_pages: int,
        name: str = "",
        materialize: bool = True,
    ):
        self.engine = engine
        self.page_bytes = page_bytes
        self.num_pages = num_pages
        self.segment: Segment = engine.register_segment(
            location, page_bytes * num_pages, name=name or f"kvpool@{location.node}",
            materialize=materialize,
        )
        self._free: List[int] = list(range(num_pages))
        self._allocated: Dict[int, int] = {}  # slot -> page_id of the live Page
        self._next_id = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[Page]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._next_id += 1
        self._allocated[slot] = self._next_id
        return Page(page_id=self._next_id, pool=self, offset=slot * self.page_bytes)

    def free(self, page: Page) -> None:
        """Return a page to the free list. Double-frees and foreign-pool pages
        raise instead of silently corrupting the free list (a corrupted list
        hands the same slot to two allocations)."""
        if page.pool is not self:
            raise ValueError(
                f"page {page.page_id} belongs to {page.pool.segment.name!r}, "
                f"not {self.segment.name!r}")
        slot = page.offset // self.page_bytes
        live = self._allocated.get(slot)
        if live != page.page_id:
            raise ValueError(
                f"double free of slot {slot} in {self.segment.name!r} "
                f"(page {page.page_id}, live page {live})")
        del self._allocated[slot]
        self._free.append(slot)

    # raw access used by tests / the real-compute example
    def read_page(self, page: Page) -> np.ndarray:
        return self.segment.read(page.offset, self.page_bytes)

    def write_page(self, page: Page, data: np.ndarray) -> None:
        assert data.size == self.page_bytes
        self.segment.write(page.offset, data)


def make_gpu_pool(engine: TentEngine, node: int, gpu: int, *, page_bytes: int, num_pages: int, materialize: bool = True) -> PagePool:
    spec = engine.topology.spec
    loc = Location(node=node, kind=MemoryKind.DEVICE_HBM, device=gpu, numa=spec.node.gpu_numa(gpu))
    return PagePool(engine, loc, page_bytes=page_bytes, num_pages=num_pages, name=f"gpu{gpu}@n{node}", materialize=materialize)


def make_cpu_pool(engine: TentEngine, node: int, *, page_bytes: int, num_pages: int, numa: int = 0, materialize: bool = True) -> PagePool:
    loc = Location(node=node, kind=MemoryKind.HOST_DRAM, device=numa, numa=numa)
    return PagePool(engine, loc, page_bytes=page_bytes, num_pages=num_pages, name=f"cpu@n{node}", materialize=materialize)


def make_disk_pool(engine: TentEngine, node: int, *, page_bytes: int, num_pages: int, materialize: bool = True) -> PagePool:
    loc = Location(node=node, kind=MemoryKind.FILE, device=0, numa=0)
    return PagePool(engine, loc, page_bytes=page_bytes, num_pages=num_pages, name=f"disk@n{node}", materialize=materialize)
