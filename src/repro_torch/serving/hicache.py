"""HiCache-style multi-tier KV hierarchy over TENT (paper §5.1.1).

RadixAttention-flavored prefix reuse: cached KV pages are indexed by the
hash-chain of the token prefix they cover. `fetch_prefix` returns the longest
cached prefix and *promotes* its pages to the GPU tier — every promotion and
eviction is a declarative TENT batch transfer, so the transfer engine (not
this cache) decides rails, slicing, staging, and failover. Swapping the
engine's policy between "tent" and "round_robin"/"pinned" is exactly the
Table-2 ablation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs.base import ModelConfig
from ..core import TentEngine
from .kvcache import Page, PagePool, kv_bytes_per_token

TIERS = ("gpu", "cpu", "disk")


def _hash_chain(prev: int, chunk: Tuple[int, ...]) -> int:
    h = prev
    for t in chunk:
        h = (h * 1_000_003 + int(t) + 1) & 0xFFFFFFFFFFFF
    return h


@dataclasses.dataclass
class CacheEntry:
    key: int
    tier: str
    page: Page
    last_used: int
    token_count: int
    # reference count of in-flight operations holding this entry's page (an
    # async promotion whose bytes are still on the wire, a fetch chain being
    # assembled): pinned entries are never eviction victims, so an overlapping
    # demotion can never free or delete a page another request still needs.
    pins: int = 0


@dataclasses.dataclass
class FetchResult:
    prefix_tokens: int  # tokens served from cache
    pages: List[Page]
    promoted_pages: int
    transfer_seconds: float  # virtual fabric time spent promoting
    bytes_moved: int


class HiCache:
    """Three-tier KV cache (GPU / CPU / disk) with LRU demotion."""

    def __init__(
        self,
        engine: TentEngine,
        cfg: ModelConfig,
        *,
        gpu_pool: PagePool,
        cpu_pool: PagePool,
        disk_pool: Optional[PagePool] = None,
        page_tokens: int = 64,
    ):
        self.engine = engine
        self.cfg = cfg
        self.page_tokens = page_tokens
        self.page_bytes = kv_bytes_per_token(cfg) * page_tokens
        self.pools: Dict[str, Optional[PagePool]] = {
            "gpu": gpu_pool, "cpu": cpu_pool, "disk": disk_pool,
        }
        self.index: Dict[int, CacheEntry] = {}
        self._clock = 0
        # stats
        self.hits = self.misses = 0
        self.bytes_promoted = 0
        self.bytes_demoted = 0

    # ------------------------------------------------------------- helpers
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _prefix_keys(self, tokens: Sequence[int]) -> List[int]:
        keys = []
        h = 0
        n_pages = len(tokens) // self.page_tokens
        for i in range(n_pages):
            chunk = tuple(tokens[i * self.page_tokens : (i + 1) * self.page_tokens])
            h = _hash_chain(h, chunk)
            keys.append(h)
        return keys

    def _transfer_pages(self, moves: List[Tuple[Page, Page]]) -> float:
        """One declarative batch for all page moves; returns virtual seconds."""
        if not moves:
            return 0.0
        t0 = self.engine.fabric.now
        batch = self.engine.allocate_batch()
        self.engine.submit_transfer(
            batch,
            [
                (src.pool.segment.segment_id, src.offset,
                 dst.pool.segment.segment_id, dst.offset, src.nbytes)
                for src, dst in moves
            ],
        )
        res = self.engine.wait(batch)
        assert res.ok, res.error
        return self.engine.fabric.now - t0

    def _victim(self, tier: str, pinned: frozenset) -> CacheEntry:
        victims = [
            e for e in self.index.values()
            if e.tier == tier and e.key not in pinned and e.pins == 0
        ]
        if not victims:
            raise RuntimeError(f"{tier} pool too small for working set")
        return min(victims, key=lambda e: e.last_used)

    def _make_room(self, tier: str, pages_needed: int, pinned: frozenset = frozenset()) -> float:
        """LRU-demote entries out of `tier` until pages_needed fit. Entries in
        `pinned` (e.g. the prefix chain being fetched) or with a nonzero pin
        count are never victims."""
        pool = self.pools[tier]
        secs = 0.0
        assert pool is not None
        while pool.free_pages < pages_needed:
            secs += self._demote(self._victim(tier, pinned), pinned)
        return secs

    def _next_tier(self, tier: str) -> Optional[str]:
        i = TIERS.index(tier)
        for t in TIERS[i + 1 :]:
            if self.pools.get(t) is not None:
                return t
        return None

    def _demote(self, entry: CacheEntry, pinned: frozenset = frozenset()) -> float:
        # `pinned` must ride along: making room in the next tier for this
        # victim may itself evict — without the set, a nested eviction could
        # free or delete an entry of the very chain being fetched.
        dst_tier = self._next_tier(entry.tier)
        if dst_tier is None:
            self.pools[entry.tier].free(entry.page)
            del self.index[entry.key]
            return 0.0
        dst_pool = self.pools[dst_tier]
        secs = self._make_room(dst_tier, 1, pinned)
        dst_page = dst_pool.alloc()
        assert dst_page is not None
        secs += self._transfer_pages([(entry.page, dst_page)])
        self.bytes_demoted += entry.page.nbytes
        self.pools[entry.tier].free(entry.page)
        entry.page, entry.tier = dst_page, dst_tier
        return secs

    def _plan_room(
        self, tier: str, pages_needed: int, pinned: frozenset,
        moves: List[Tuple[Page, Page]],
    ) -> None:
        """Async-mode room making: select LRU victims (cascading down the
        hierarchy), rebind their pages *now* and append the wire moves to
        `moves` for one deferred declarative batch. All index/pool bookkeeping
        is synchronous at submit time; only the wire time is asynchronous, so
        overlapping requests always see a consistent cache."""
        pool = self.pools[tier]
        assert pool is not None
        while pool.free_pages < pages_needed:
            victim = self._victim(tier, pinned)
            dst_tier = self._next_tier(tier)
            if dst_tier is None:
                pool.free(victim.page)
                del self.index[victim.key]
                continue
            self._plan_room(dst_tier, 1, pinned, moves)
            dst = self.pools[dst_tier].alloc()
            assert dst is not None
            moves.append((victim.page, dst))
            self.bytes_demoted += victim.page.nbytes
            pool.free(victim.page)
            victim.page, victim.tier = dst, dst_tier

    # ------------------------------------------------------------- API
    def fetch_prefix(self, tokens: Sequence[int]) -> FetchResult:
        """Longest cached prefix, promoted to GPU. The promotion transfer is
        the latency-critical elephant flow of Table 2."""
        keys = self._prefix_keys(tokens)
        chain: List[CacheEntry] = []
        for k in keys:
            e = self.index.get(k)
            if e is None:
                break
            chain.append(e)
        if not chain:
            self.misses += 1
            return FetchResult(0, [], 0, 0.0, 0)
        self.hits += 1
        now = self._tick()
        for e in chain:
            e.last_used = now
        pinned = frozenset(e.key for e in chain)
        moves: List[Tuple[Page, Page]] = []
        new_pages: List[Tuple[CacheEntry, Page]] = []
        promoted = 0
        room_secs = 0.0
        need = sum(1 for e in chain if e.tier != "gpu")
        if need:
            room_secs += self._make_room("gpu", need, pinned)
        for e in chain:
            if e.tier != "gpu":
                dst = self.pools["gpu"].alloc()
                assert dst is not None
                moves.append((e.page, dst))
                new_pages.append((e, dst))
                promoted += 1
        secs = self._transfer_pages(moves) + room_secs
        for e, dst in new_pages:
            self.pools[e.tier].free(e.page)
            e.page, e.tier = dst, "gpu"
        nbytes = promoted * self.page_bytes
        self.bytes_promoted += nbytes
        return FetchResult(
            prefix_tokens=len(chain) * self.page_tokens,
            pages=[e.page for e in chain],
            promoted_pages=promoted,
            transfer_seconds=secs,
            bytes_moved=nbytes,
        )

    def fetch_prefix_async(
        self, tokens: Sequence[int], on_done: Callable[[FetchResult], None]
    ) -> None:
        """Non-blocking `fetch_prefix`: the promotion (plus any demotions it
        forces) is submitted as one declarative batch whose completion
        callback delivers the `FetchResult` — the caller's virtual clock only
        advances when the fabric does, so concurrent requests' promotions
        genuinely overlap and contend. Cache bookkeeping (index rebinds, page
        alloc/free) happens synchronously at submit; the chain stays pinned
        until the bytes land."""
        keys = self._prefix_keys(tokens)
        chain: List[CacheEntry] = []
        for k in keys:
            e = self.index.get(k)
            if e is None:
                break
            chain.append(e)
        if not chain:
            self.misses += 1
            on_done(FetchResult(0, [], 0, 0.0, 0))
            return
        self.hits += 1
        now = self._tick()
        for e in chain:
            e.last_used = now
        pinned = frozenset(e.key for e in chain)
        moves: List[Tuple[Page, Page]] = []
        need = [e for e in chain if e.tier != "gpu"]
        if need:
            self._plan_room("gpu", len(need), pinned, moves)
        for e in need:
            dst = self.pools["gpu"].alloc()
            assert dst is not None
            moves.append((e.page, dst))
            self.pools[e.tier].free(e.page)
            e.page, e.tier = dst, "gpu"
        nbytes = len(need) * self.page_bytes
        self.bytes_promoted += nbytes
        result = FetchResult(
            prefix_tokens=len(chain) * self.page_tokens,
            pages=[e.page for e in chain],
            promoted_pages=len(need),
            transfer_seconds=0.0,
            bytes_moved=nbytes,
        )
        if not moves:
            on_done(result)
            return
        for e in chain:
            e.pins += 1
        t0 = self.engine.fabric.now
        batch = self.engine.allocate_batch()
        self.engine.submit_transfer(
            batch,
            [
                (src.pool.segment.segment_id, src.offset,
                 dst.pool.segment.segment_id, dst.offset, src.nbytes)
                for src, dst in moves
            ],
        )

        def _landed(res):
            assert res.ok, res.error
            for e in chain:
                e.pins -= 1
            on_done(dataclasses.replace(
                result, transfer_seconds=self.engine.fabric.now - t0))

        self.engine.on_batch_done(batch, _landed)

    def insert_async(
        self, tokens: Sequence[int],
        on_done: Optional[Callable[[float], None]] = None,
    ) -> None:
        """Non-blocking `insert`: demotions forced by making room ship as one
        batch; new entries are indexed immediately (their KV was just computed
        on the GPU, no wire move needed). `on_done` receives the demotion
        transfer seconds once the evicted bytes land."""
        keys = self._prefix_keys(tokens)
        now = self._tick()
        moves: List[Tuple[Page, Page]] = []
        for k in keys:
            if k in self.index:
                self.index[k].last_used = now
                continue
            self._plan_room("gpu", 1, frozenset(), moves)
            page = self.pools["gpu"].alloc()
            assert page is not None
            self.index[k] = CacheEntry(
                key=k, tier="gpu", page=page, last_used=now,
                token_count=self.page_tokens,
            )
        if not moves:
            if on_done is not None:
                on_done(0.0)
            return
        t0 = self.engine.fabric.now
        batch = self.engine.allocate_batch()
        self.engine.submit_transfer(
            batch,
            [
                (src.pool.segment.segment_id, src.offset,
                 dst.pool.segment.segment_id, dst.offset, src.nbytes)
                for src, dst in moves
            ],
        )

        def _landed(res):
            assert res.ok, res.error
            if on_done is not None:
                on_done(self.engine.fabric.now - t0)

        self.engine.on_batch_done(batch, _landed)

    def insert(self, tokens: Sequence[int], payload: Optional[np.ndarray] = None) -> float:
        """Insert KV pages for `tokens` into the GPU tier (post-prefill).
        Returns virtual seconds spent making room (demotions)."""
        keys = self._prefix_keys(tokens)
        now = self._tick()
        secs = 0.0
        for i, k in enumerate(keys):
            if k in self.index:
                self.index[k].last_used = now
                continue
            secs += self._make_room("gpu", 1)
            page = self.pools["gpu"].alloc()
            assert page is not None
            if payload is not None:
                page.pool.write_page(
                    page,
                    payload[i * self.page_bytes : (i + 1) * self.page_bytes],
                )
            self.index[k] = CacheEntry(
                key=k, tier="gpu", page=page, last_used=now, token_count=self.page_tokens
            )
        return secs

    def tier_counts(self) -> Dict[str, int]:
        out = {t: 0 for t in TIERS}
        for e in self.index.values():
            out[e.tier] += 1
        return out
