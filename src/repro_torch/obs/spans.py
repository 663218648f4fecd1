"""Host-clock spans of the serving path: where a request's wall time goes.

The flight recorder (`recorder.py`) runs on the simulated fabric's virtual
clock and answers *why* the scheduler did what it did. This module answers
*how long* each part of a request took on the host, on the host's clock
(`time.perf_counter_ns`): the model's prefill and decode steps, the KV
handoff's packing, segment registration, stage-in and unpacking, and the
engine's submission and event loop.

Zero-cost-when-off contract, as the flight recorder's: the process holds
one slot, `active`, which is None until `attach` puts a `SpanRecorder`
there, and every record site is one `active` load and one `is not None`
branch per call or batch; `Segment.read`, `read_in_place` and `write`,
where the bytes move, are the one site per slice.

Two kinds of record sites:

- **Spans** (`span`, `request`, `mark`): named intervals with a parent and
  the request id of the `request()` they run under. While a
  `torch.profiler` is recording, each span also opens
  `record_function("tent." + name)`, so the program's ranges sit on the
  device trace's clock. The recorder holds a request's spans only where
  its caller asked for them, `request(keep=True)`, and then until `take`:
  the spans of any other request, and spans opened outside a request,
  are forgotten as they close, so a recorder left attached to a server
  grows no store.
- **Accumulators** (`begin` / `end`): fine-grained work that opens no span
  and no range, charged to the innermost open span's counters: the
  engine's dispatches (`dispatch_ns`, `dispatch_n`), completion drains
  (`drain_ns`, `drain_n`) and the segments' byte copies (`copy_ns`,
  `copy_bytes`). They are exclusive: a drain's nanoseconds leave out the
  dispatch and the copies that run inside it, so no nanosecond is counted
  twice, and a span's time less its accumulators' is its own.
- **Counts** (`count`): a number with no time, on the innermost open
  span: the bytes a segment read hands out in place (`inplace_bytes`).

Recording is passive: nothing here schedules a fabric event, touches
engine state or changes a byte that moves.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, List, Optional

# the attached recorder; None = tracing off
active: Optional["SpanRecorder"] = None

REQUEST = "serve.request"
RANGE_PREFIX = "tent."

_OFF = contextlib.nullcontext()


class Span:
    """One interval on the host clock, in nanoseconds."""

    __slots__ = ("id", "name", "start", "end", "parent", "request", "counters", "_range")

    def __init__(self, sid: int, name: str, start: int, parent: int, request: int):
        self.id = sid
        self.name = name
        self.start = start
        self.end = start
        self.parent = parent  # id of the enclosing span; 0 at the root
        self.request = request  # id of the enclosing request(); 0 outside one
        self.counters: Dict[str, int] = {}
        self._range = None

    @property
    def ns(self) -> int:
        return self.end - self.start


class _Open:
    """Context manager of one span: opens it on entry, closes it on exit."""

    __slots__ = ("rec", "name", "request", "span", "depth")

    def __init__(self, rec: "SpanRecorder", name: str, request: int):
        self.rec, self.name, self.request = rec, name, request

    def __enter__(self) -> Span:
        self.depth = len(self.rec._saved)
        self.span = self.rec._open_span(self.name, self.request)
        return self.span

    def __exit__(self, *exc) -> None:
        rec = self.rec
        # an exception inside an accumulator skips its `end`: drop what it left
        del rec._saved[self.depth:]
        rec._close_span(self.span)


class SpanRecorder:
    """Spans of the kept requests in memory, until `take` hands them over."""

    def __init__(self):
        import torch

        self._profiling = torch.autograd._profiler_enabled
        self._record_function = torch.profiler.record_function
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._open: List[Span] = []  # the open spans, innermost last
        self._kept: Dict[int, List[Span]] = {}  # spans of each kept request
        # accumulators: the inner nanoseconds of the enclosing ones
        self._saved: List[int] = []
        self._inner = 0

    # -- spans -------------------------------------------------------------

    def span(self, name: str) -> _Open:
        """A span under the innermost open one, in its request."""
        return _Open(self, name, -1)

    def request(self, keep: bool = False):
        """A root span, `serve.request`, with a fresh request id; every span
        opened inside it carries that id. With `keep`, the recorder holds
        the request's spans until `take`. Inside an open request it opens
        nothing: the work is part of that request."""
        if self._open and self._open[-1].request:
            return _OFF
        rid = next(self._requests)
        if keep:
            self._kept[rid] = []
        return _Open(self, REQUEST, rid)

    def mark(self, name: str) -> Span:
        """A span of no length: an instant in the innermost open span."""
        sp = self._open_span(name, -1, ranged=False)
        self._close_span(sp)
        sp.end = sp.start
        return sp

    def _open_span(self, name: str, request: int, ranged: bool = True) -> Span:
        top = self._open[-1] if self._open else None
        if request < 0:
            request = top.request if top is not None else 0
        sp = Span(next(self._ids), name, 0, top.id if top is not None else 0, request)
        kept = self._kept.get(request)
        if kept is not None:
            kept.append(sp)
        self._open.append(sp)
        if ranged and self._profiling():
            sp._range = self._record_function(RANGE_PREFIX + name)
            sp._range.__enter__()
        sp.start = time.perf_counter_ns()
        return sp

    def _close_span(self, sp: Span) -> None:
        sp.end = time.perf_counter_ns()
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
            sp._range = None
        # spans close innermost first; one left open by an exception closes here
        while self._open and self._open.pop() is not sp:
            pass

    def take(self, request: int) -> List[Span]:
        """A kept request's spans in the order they opened; the recorder
        forgets them."""
        return self._kept.pop(request, [])

    # -- accumulators ------------------------------------------------------

    def begin(self) -> int:
        """Start of an accumulated piece of work; returns its start."""
        self._saved.append(self._inner)
        self._inner = 0
        return time.perf_counter_ns()

    def end(self, t0: int, ns_key: str, count_key: str, count: int) -> None:
        """Charge the work since `t0`, less the accumulated work inside it,
        to `ns_key` of the innermost open span, and `count` to `count_key`."""
        dt = time.perf_counter_ns() - t0
        own = dt - self._inner
        self._inner = (self._saved.pop() if self._saved else 0) + dt
        if self._open:
            c = self._open[-1].counters
            c[ns_key] = c.get(ns_key, 0) + own
            c[count_key] = c.get(count_key, 0) + count

    def count(self, key: str, n: int) -> None:
        """Add `n` to counter `key` of the innermost open span: a count with
        no time, such as the bytes a read hands out in place."""
        if self._open:
            c = self._open[-1].counters
            c[key] = c.get(key, 0) + n


def attach(rec: Optional[SpanRecorder] = None) -> SpanRecorder:
    """Turn tracing on: `rec`, or a new recorder, becomes `active`."""
    global active
    active = rec if rec is not None else SpanRecorder()
    return active


def detach() -> Optional[SpanRecorder]:
    """Turn tracing off; returns the recorder that was attached."""
    global active
    rec, active = active, None
    return rec


def span(name: str):
    """`active.span(name)`, or a context that does nothing when off."""
    rec = active
    return _OFF if rec is None else rec.span(name)


def request(keep: bool = False):
    """`active.request(keep)`, or a context that does nothing when off."""
    rec = active
    return _OFF if rec is None else rec.request(keep)
