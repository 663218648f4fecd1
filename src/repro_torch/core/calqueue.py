"""Calendar queue: a bucketed timestamp wheel for the fabric event loop.

A binary heap pays O(log n) per push/pop; at 10^5+ in-flight operations
(production-scale serving streams) that log factor is most of the event
loop's cost. A calendar queue exploits what heaps cannot: simulation
timestamps are *almost sorted* — events land a bounded horizon ahead of the
clock. Entries hash into fixed-width time buckets (`bucket = int(t /
width)`); only the bucket currently being drained is kept heap-ordered, all
future buckets are unordered append-only lists, and a small index heap of
non-empty bucket ids finds the next bucket to drain. Push is O(1) amortized
(a list append for any future bucket), pop is O(1) amortized plus one
heapify per bucket crossed.

Ordering contract (the bit-parity requirement): entries are the fabric's
`(time, seq, item)` tuples and pop order is *exactly* ascending `(time,
seq)` — identical to `heapq` on one flat list — so a `Fabric` running on a
calendar queue replays the same event sequence, the same RNG draw order,
and therefore the same simulation, byte for byte (pinned across the full
scenario library in tests/test_calendar_parity.py). Ties on `time` drain in
`seq` (post) order because the tuples compare lexicographically inside the
current bucket's heap.

Two structural invariants make the exact ordering cheap to keep:

* the clock is monotonic and `Fabric.call_at` clamps `t >= now`, so a push
  can target the *current* bucket (it joins the current heap) but never an
  already-drained one;
* a peek may advance the wheel to a future bucket before the clock gets
  there (`run_until` probes the next event time); a later push landing
  *between* the clock and that bucket is routed into the current heap too
  (`bucket <= cur_id`), which preserves global order because every future
  bucket's entries are strictly later than the entire current bucket span.

Width adapts online: when a drained bucket exceeds `resize_threshold`
entries, the width shrinks 4x and the wheel rebuilds (O(n), amortized over
the pops that follow). A badly sized width never affects ordering — in the
degenerate one-bucket case the structure *is* a binary heap.
"""
from __future__ import annotations

import heapq
from ..analysis import hot_path
from typing import List, Optional, Tuple

__all__ = ["CalendarQueue", "DEFAULT_WIDTH", "RESIZE_THRESHOLD"]

# Default bucket width (virtual seconds). The library's scenarios span
# microsecond service times to multi-second serving streams; 1 ms buckets
# keep both regimes off the degenerate paths, and the resize rule below
# corrects the rest.
DEFAULT_WIDTH = 1e-3

# A drained bucket larger than this triggers a 4x width shrink + rebuild.
RESIZE_THRESHOLD = 4096

# Never shrink below this width: degenerate timestamp distributions (many
# events at one instant) would otherwise rebuild forever without ever
# thinning the bucket.
MIN_WIDTH = 1e-9

Entry = Tuple[float, int, object]


class CalendarQueue:
    """Min-priority queue over `(time, seq, item)` tuples with exact
    `heapq`-equivalent pop order. Supports the four operations the fabric
    event loop needs: `push`, `pop`, `peek`, and truthiness."""

    __slots__ = ("width", "buckets", "index", "cur", "cur_id", "_len",
                 "resize_threshold")

    def __init__(self, width: float = DEFAULT_WIDTH, *,
                 resize_threshold: int = RESIZE_THRESHOLD):
        if width <= 0:
            raise ValueError(f"bucket width must be > 0, got {width}")
        self.width = float(width)
        self.resize_threshold = int(resize_threshold)
        self.buckets: dict = {}  # bucket id -> unordered entry list
        self.index: List[int] = []  # heap of non-empty future bucket ids
        self.cur: List[Entry] = []  # the bucket being drained, heap-ordered
        self.cur_id: Optional[int] = None
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    @hot_path

    def push(self, entry: Entry) -> None:
        bid = int(entry[0] / self.width)
        cur_id = self.cur_id
        if cur_id is not None and bid <= cur_id:
            # current-bucket (or pre-advanced-wheel) landing: joins the
            # ordered heap so it drains before every future bucket
            heapq.heappush(self.cur, entry)
        else:
            lst = self.buckets.get(bid)
            if lst is None:
                self.buckets[bid] = [entry]
                heapq.heappush(self.index, bid)
            else:
                lst.append(entry)
        self._len += 1

    @hot_path

    def pop(self) -> Entry:
        if not self.cur:
            self._advance()
        self._len -= 1
        return heapq.heappop(self.cur)

    def peek(self) -> Entry:
        if not self.cur:
            self._advance()
        return self.cur[0]

    # -- internals -----------------------------------------------------------
    def _advance(self) -> None:
        """Make the next non-empty bucket current (caller guarantees the
        queue is non-empty). Oversized buckets trigger a width shrink and a
        full rebuild before draining."""
        bid = heapq.heappop(self.index)
        lst = self.buckets.pop(bid)
        if len(lst) > self.resize_threshold and self.width > MIN_WIDTH:
            self.buckets[bid] = lst
            heapq.heappush(self.index, bid)
            self.width = max(self.width / 4.0, MIN_WIDTH)
            self._rebuild()
            self._advance()
            return
        heapq.heapify(lst)
        self.cur = lst
        self.cur_id = bid

    def _rebuild(self) -> None:
        """Redistribute every entry under the (new) width. Resets the wheel
        position; the next `_advance` re-derives it from the entries."""
        entries: List[Entry] = list(self.cur)
        for lst in self.buckets.values():
            entries.extend(lst)
        self.buckets.clear()
        self.index = []
        self.cur = []
        self.cur_id = None
        n = self._len
        for e in entries:
            self.push(e)
        self._len = n  # push() re-counted the existing entries
