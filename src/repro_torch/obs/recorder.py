"""Array-backed flight recorder for the spray engine.

The recorder is a fixed-capacity ring buffer of `(ts, kind, payload)`
records on the virtual clock. Timestamps and kinds live in preallocated
numpy arrays (`float64` / `int16`); payloads are per-kind dicts held in a
parallel list. One `append` is a couple of array stores plus a list slot
write — cheap enough that instrumented code records at *batch* granularity
(one append per wave, per drain run, per gossip rumor) without disturbing
the vectorized hot path.

Zero-cost-when-off contract: nothing in this module is ever touched unless
a recorder is attached. Instrumented call sites hold `self._rec = None` by
default and guard every record with a single `rec = self._rec` load and
`is not None` branch per batch — the pattern the hot-path bench gates pin.

Recording is strictly passive: the recorder never schedules fabric events,
never mutates engine state, and payloads only reference freshly-built or
immutable values, so attaching a recorder cannot perturb a simulation
(pinned by the tracing-ON/OFF report-parity tests).

Identity interning: raw `Slice.slice_id` / batch ids come from process-
global counters and differ between two runs in the same process. `sid()`
and `bid()` map them to dense ids in first-seen order — deterministic for a
given spec + seed — and all read-side payloads and exports use only the
dense ids. Interning is *deferred off the hot path*: record sites store
`Slice` references under the `slice`/`slices` payload keys (the identity
fields — slice_id, batch_id, src_offset, length — are immutable), and the
first read (`events()`) interns them in event order, so the engine's timed
path never pays the per-slice dict work (~300us per 512-slice wave).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from .events import KIND_NAMES


class FlightRecorder:
    """Ring buffer of structured events with dense slice/batch interning."""

    __slots__ = ("capacity", "_ts", "_kind", "_payload", "_n",
                 "_sids", "_bids", "_slice_meta", "_norm_upto")

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._ts = np.zeros(self.capacity, dtype=np.float64)
        self._kind = np.zeros(self.capacity, dtype=np.int16)
        self._payload: List[object] = [None] * self.capacity
        self._n = 0  # total appends ever; ring slot is _n % capacity
        self._sids: Dict[int, int] = {}
        self._bids: Dict[int, int] = {}
        # per dense sid: (dense batch id, src_offset, length)
        self._slice_meta: List[Tuple[int, int, int]] = []
        self._norm_upto = 0  # total-append watermark of lazy interning

    # -- recording ---------------------------------------------------------

    def append(self, kind: int, ts: float, payload: dict) -> None:
        i = self._n % self.capacity
        self._ts[i] = ts
        self._kind[i] = kind
        self._payload[i] = payload
        self._n += 1

    def sid(self, sl) -> int:
        """Dense id for a slice (interned on first sight, meta retained)."""
        m = self._sids
        s = m.get(sl.slice_id)
        if s is None:
            s = m[sl.slice_id] = len(m)
            self._slice_meta.append((self.bid(sl.batch_id),
                                     sl.src_offset, sl.length))
        return s

    def bid(self, batch_id: int) -> int:
        """Dense id for an application batch."""
        m = self._bids
        b = m.get(batch_id)
        if b is None:
            b = m[batch_id] = len(m)
        return b

    # -- reading -----------------------------------------------------------

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def dropped(self) -> int:
        """Events overwritten because the ring wrapped."""
        return max(0, self._n - self.capacity)

    def _normalize(self) -> None:
        """Intern `Slice` references left in payloads by the hot path into
        dense ids, oldest retained event first. Appends may continue after a
        read; the watermark makes later reads intern only the new tail, so
        first-seen order — and with it trace byte-determinism — holds no
        matter when or how often the recorder is read."""
        cap = self.capacity
        start = max(self._norm_upto, self._n - cap)
        if start >= self._n:
            return
        sid = self.sid
        for k in range(start, self._n):
            pl = self._payload[k % cap]
            sls = pl.get("slices")
            # INTENT reuses the key for a plain int count; WAVE/COMPLETE
            # store lists (of Slice refs pre-normalization)
            if type(sls) is list and sls and not isinstance(sls[0], int):
                pl["slices"] = [sid(s) for s in sls]
            sl = pl.get("slice")
            if sl is not None and not isinstance(sl, int):
                pl["slice"] = sid(sl)
        self._norm_upto = self._n

    def events(self) -> Iterator[Tuple[float, int, dict]]:
        """Retained events, oldest first (wraparound-aware). Payload slice
        references are interned to dense ids on first read."""
        self._normalize()
        cap = self.capacity
        for k in range(max(0, self._n - cap), self._n):
            i = k % cap
            yield float(self._ts[i]), int(self._kind[i]), self._payload[i]

    def slice_info(self, sid: int) -> Tuple[int, int, int]:
        """(dense batch id, src_offset, length) for a dense slice id."""
        return self._slice_meta[sid]

    def n_slices(self) -> int:
        return len(self._sids)

    def n_batches(self) -> int:
        return len(self._bids)

    def counts(self) -> Dict[str, int]:
        """Retained-event count per kind name (for summaries/tests)."""
        out: Dict[str, int] = {}
        kinds = self._kind if self._n >= self.capacity \
            else self._kind[:self._n]
        vals, freq = np.unique(kinds, return_counts=True)
        for v, f in zip(vals, freq):
            out[KIND_NAMES.get(int(v), f"kind_{int(v)}")] = int(f)
        return out
