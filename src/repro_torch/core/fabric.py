"""Deterministic discrete-event fabric simulator.

This is the "hardware" under the transport backends. Each physical link is a
serial resource with nominal bandwidth, base latency, a NUMA-crossing
submission cost, multiplicative time-varying degradation, stochastic service
jitter, and scheduled failures (flaps). Wire operations occupy a source link
and optionally a destination link (two-resource serialization models receiver
incast). The virtual clock makes the paper's latency/throughput/resilience
experiments exactly reproducible.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from functools import partial
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import events as OBS
from .calqueue import DEFAULT_WIDTH, CalendarQueue
from .topology import LinkDesc, Topology

# completion callback: (ok, start_time, end_time, error_code) — or, for
# tagged posts, (tag, ok, start_time, end_time, error_code): a wave of ops
# shares ONE callback object and each op carries its own tag, so batched
# posting allocates no per-op closure.
Completion = Callable[[bool, float, float, str], None]

# batched completion sink: (ops, now) — every op in `ops` completed at the
# same virtual timestamp `now`; failed ones carry op.failed=True. Registered
# per shared completion callback via `Fabric.register_completion_sink`.
CompletionSink = Callable[[List["WireOp"], float], None]

# batched post spec: (src_link, dst_link, nbytes, extra_latency, bw_scale, tag)
PostSpec = Tuple[int, Optional[int], int, float, float, object]

_op_ids = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Event-loop configuration, following the `wave`/`wave_complete`/
    `jit_core` discipline: the default is the reference implementation, the
    alternative is bit-identical and regression-pinned.

    event_queue:
        "heap"     — one flat binary heap (the reference; O(log n) per op).
        "calendar" — bucketed timestamp wheel (`repro_torch.core.calqueue`);
                     O(1) amortized push/pop, same pop order byte for byte.
                     Pays off once in-flight events reach 10^4-10^5+
                     (production-scale serving streams); at small scale the
                     constant factors roughly cancel.
    calendar_width:
        Initial bucket width in virtual seconds; 0 = library default. The
        wheel self-resizes, so this is a hint, not a tuning obligation.
    """

    event_queue: str = "heap"
    calendar_width: float = 0.0

    def __post_init__(self):
        if self.event_queue not in ("heap", "calendar"):
            raise ValueError(f"unknown event_queue {self.event_queue!r}")
        if self.calendar_width < 0:
            raise ValueError(
                f"calendar_width must be >= 0, got {self.calendar_width}")


@dataclasses.dataclass(slots=True)
class WireOp:
    op_id: int
    src_link: int
    dst_link: Optional[int]
    nbytes: int
    extra_latency: float
    on_complete: Completion
    start: float = 0.0
    end: float = 0.0
    cancelled: bool = False
    failed: bool = False
    tenant: Optional[str] = None  # posting engine on a shared fabric
    tag: object = None  # shared-callback correlation key (batched posts)


@dataclasses.dataclass
class _DegradeWindow:
    start: float
    end: float
    factor: float  # effective bandwidth multiplier in (0, 1]


# Padding sentinel for dense fault-schedule exports (`fault_window_arrays`):
# a window opening this far in the future is never active, never overlaps a
# transfer, and — unlike inf — survives arithmetic jitter without producing
# NaNs (inf - inf) in the Monte Carlo sweep's window perturbation.
FAR_WINDOW = 1e30


class LinkState:
    """Runtime state of one link."""

    def __init__(self, desc: LinkDesc, jitter: float, rng: np.random.Generator):
        self.desc = desc
        self.busy_until = 0.0
        self.failed = False
        self.fail_windows: List[Tuple[float, float]] = []
        self.degrade_windows: List[_DegradeWindow] = []
        self.jitter = jitter
        self.rng = rng
        self.outstanding: Dict[int, WireOp] = {}
        # telemetry the paper's per-NIC byte counters expose (§5.1.3)
        self.bytes_completed = 0
        self.ops_completed = 0
        self.ops_failed = 0
        # per-tenant split when several engines share the fabric (cluster)
        self.bytes_by_tenant: Dict[str, int] = {}

    def effective_bandwidth(self, t: float) -> float:
        # windows are sorted by start; expired ones are pruned as the clock
        # only moves forward (keeps this O(1) amortized under long schedules)
        while self.degrade_windows and self.degrade_windows[0].end <= t:
            self.degrade_windows.pop(0)
        bw = self.desc.bandwidth
        for w in self.degrade_windows:
            if w.start > t:
                break
            if w.start <= t < w.end:
                bw *= w.factor
        return bw

    def is_failed(self, t: float) -> bool:
        if self.failed:
            return True
        while self.fail_windows and self.fail_windows[0][1] <= t:
            self.fail_windows.pop(0)
        for s, e in self.fail_windows:
            if s > t:
                break
            if s <= t < e:
                return True
        return False


class Fabric:
    """Event-driven cluster fabric: links + virtual clock + fault schedule."""

    FAIL_DETECT_LATENCY = 200e-6  # completion-error surfacing delay (s)

    def __init__(self, topology: Topology, *, seed: int = 0, jitter: float = 0.02,
                 config: Optional["FabricConfig"] = None):
        self.topology = topology
        self.config = config or FabricConfig()
        self.now = 0.0
        # queue entries are (time, seq, item); `item` is either a zero-arg
        # callable or a WireOp whose completion is due (op entries avoid a
        # per-op `partial` allocation and let `step` recognize and group
        # same-timestamp completion runs for the batched drain)
        self._events: List[Tuple[float, int, object]] = []
        # calendar-queue alternative to the heap (FabricConfig.event_queue):
        # same (time, seq) pop order, O(1) amortized at serving-stream scale.
        # Exactly one of the two structures holds events; every loop site
        # branches on `self._cal is None` so the heap path stays verbatim.
        self._cal: Optional[CalendarQueue] = (
            CalendarQueue(self.config.calendar_width or DEFAULT_WIDTH)
            if self.config.event_queue == "calendar" else None)
        self._seq = itertools.count()
        self._rng = np.random.default_rng(seed)
        self._completion_sinks: Dict[object, CompletionSink] = {}
        # flight recorder (repro.obs); None = tracing off. Fabric-side
        # recording is passive (fault events only) and never touches the heap.
        self._rec = None
        self.links: Dict[int, LinkState] = {
            l.link_id: LinkState(l, jitter, np.random.default_rng(seed * 7919 + l.link_id))
            for l in topology.links
        }

    def attach_recorder(self, rec) -> None:
        self._rec = rec

    # -- event loop ----------------------------------------------------------
    def call_at(self, t: float, fn: Callable[[], None]) -> None:
        if t < self.now:
            t = self.now
        if self._cal is None:
            heapq.heappush(self._events, (t, next(self._seq), fn))
        else:
            self._cal.push((t, next(self._seq), fn))

    def call_after(self, dt: float, fn: Callable[[], None]) -> None:
        self.call_at(self.now + dt, fn)

    def register_completion_sink(self, on_complete, sink: CompletionSink) -> None:
        """Route completions for ops posted with the shared callback
        `on_complete` through `sink(ops, now)` in whole batches: one call
        delivers every op completing at the same virtual timestamp whose
        completion events are adjacent in the queue (heap order is execution
        order, so grouping consecutive events cannot reorder anything
        relative to timers or other callbacks at the same instant). This is
        the drain half of the paper's batched feedback loop — the engine
        registers its multi-completion handler here when
        `EngineConfig.wave_complete` is on."""
        self._completion_sinks[on_complete] = sink

    def step(self) -> bool:
        if self._cal is not None:
            return self._step_calendar()
        events = self._events
        if not events:
            return False
        t, _, fn = heapq.heappop(events)
        self.now = max(self.now, t)
        if type(fn) is WireOp:
            sink = (self._completion_sinks.get(fn.on_complete)
                    if self._completion_sinks else None)
            if sink is None:
                self._complete(fn)
                return True
            batch = [fn]
            cb = fn.on_complete
            while events and events[0][0] == t and type(events[0][2]) is WireOp \
                    and events[0][2].on_complete == cb:
                batch.append(heapq.heappop(events)[2])
            self._complete_batch(batch, sink)
            return True
        fn()
        return True

    def _step_calendar(self) -> bool:
        """`step` on the calendar queue — same semantics, same batch grouping
        of same-timestamp same-callback completion runs, via peek/pop instead
        of heap indexing."""
        cal = self._cal
        if not cal:
            return False
        t, _, fn = cal.pop()
        self.now = max(self.now, t)
        if type(fn) is WireOp:
            sink = (self._completion_sinks.get(fn.on_complete)
                    if self._completion_sinks else None)
            if sink is None:
                self._complete(fn)
                return True
            batch = [fn]
            cb = fn.on_complete
            while cal:
                head = cal.peek()
                if head[0] != t or type(head[2]) is not WireOp \
                        or head[2].on_complete != cb:
                    break
                batch.append(cal.pop()[2])
            self._complete_batch(batch, sink)
            return True
        fn()
        return True

    def run_until_idle(self, *, max_events: int = 50_000_000) -> None:
        n = 0
        while self.step():
            n += 1
            if n > max_events:
                raise RuntimeError("fabric event budget exceeded (livelock?)")

    def run_until(self, t: float) -> None:
        cal = self._cal
        if cal is None:
            while self._events and self._events[0][0] <= t:
                self.step()
        else:
            while cal and cal.peek()[0] <= t:
                self._step_calendar()
        self.now = max(self.now, t)

    @property
    def idle(self) -> bool:
        if self._cal is not None:
            return not self._cal
        return not self._events

    # -- fault / degradation schedule -----------------------------------------
    def schedule_failure(self, link_id: int, at: float, recover_at: float) -> None:
        link = self.links[link_id]
        link.fail_windows.append((at, recover_at))
        link.fail_windows.sort()
        self.call_at(at, lambda: self._on_link_fail(link_id))

    def schedule_degradation(self, link_id: int, at: float, until: float, factor: float) -> None:
        assert 0 < factor <= 1.0
        wins = self.links[link_id].degrade_windows
        wins.append(_DegradeWindow(at, until, factor))
        wins.sort(key=lambda w: w.start)
        rec = self._rec
        if rec is not None:
            # degradations install no heap event (links consult their windows
            # lazily), so record at schedule time with the window's own ts
            rec.append(OBS.DEGRADE, at, {
                "link": link_id, "until": until, "factor": factor})

    def fault_window_arrays(self, link_ids: Optional[Sequence[int]] = None):
        """Dense, padded export of the installed fault program — the fabric
        hook the jitted Monte Carlo core (`repro.core.jit_core`) compiles
        deterministic fault schedules from.

        Returns a dict of float64 arrays over `link_ids` (default: all links
        in id order): `fail_start`/`fail_end` with shape `(L, Kf)` and
        `deg_start`/`deg_end`/`deg_factor` with shape `(L, Kd)`, where
        `Kf`/`Kd` are the per-link maxima (at least 1). Unused rows are
        padded with `FAR_WINDOW` starts/ends (factor 1.0), which no virtual
        timestamp ever reaches. Snapshot semantics: call before driving the
        clock — `is_failed`/`effective_bandwidth` prune expired windows
        lazily, so a mid-run export only sees the remaining schedule."""
        if link_ids is None:
            link_ids = sorted(self.links)
        states = [self.links[lid] for lid in link_ids]
        kf = max(1, max((len(s.fail_windows) for s in states), default=1))
        kd = max(1, max((len(s.degrade_windows) for s in states), default=1))
        n = len(states)
        out = {
            "link_ids": np.asarray(link_ids, dtype=np.int64),
            "fail_start": np.full((n, kf), FAR_WINDOW, dtype=np.float64),
            "fail_end": np.full((n, kf), FAR_WINDOW, dtype=np.float64),
            "deg_start": np.full((n, kd), FAR_WINDOW, dtype=np.float64),
            "deg_end": np.full((n, kd), FAR_WINDOW, dtype=np.float64),
            "deg_factor": np.ones((n, kd), dtype=np.float64),
        }
        for i, st in enumerate(states):
            for k, (s, e) in enumerate(st.fail_windows):
                out["fail_start"][i, k] = s
                out["fail_end"][i, k] = e
            for k, w in enumerate(st.degrade_windows):
                out["deg_start"][i, k] = w.start
                out["deg_end"][i, k] = w.end
                out["deg_factor"][i, k] = w.factor
        return out

    def _on_link_fail(self, link_id: int) -> None:
        """Abort all in-flight ops on the failed link (paper §2.3: a flapping
        NIC stops accepting work requests; in-flight transfers abort)."""
        link = self.links[link_id]
        rec = self._rec
        if rec is not None:
            until = next((e for s, e in link.fail_windows
                          if s <= self.now < e), -1.0)
            rec.append(OBS.LINK_FAIL, self.now, {
                "link": link_id, "until": until,
                "aborted": sum(1 for op in link.outstanding.values()
                               if not op.cancelled)})
        for op in list(link.outstanding.values()):
            if not op.cancelled:
                op.cancelled = True
                op.failed = True
                self._release(op)
                self.call_after(
                    self.FAIL_DETECT_LATENCY, partial(self._deliver_abort, op))
        link.busy_until = self.now

    def _deliver(self, op: WireOp, ok: bool, t0: float, t1: float, err: str) -> None:
        """Invoke an op's completion: tagged ops share one callback and get
        their tag back as the first argument; plain ops keep the legacy
        4-argument shape."""
        if op.tag is not None:
            op.on_complete(op.tag, ok, t0, t1, err)
        else:
            op.on_complete(ok, t0, t1, err)

    def _deliver_abort(self, op: WireOp) -> None:
        self._deliver(op, False, op.start, self.now, "LinkFailed")

    def _deliver_reject(self, op: WireOp) -> None:
        self._deliver(op, False, self.now, self.now, "LinkFailed")

    # -- data path -------------------------------------------------------------
    def post(
        self,
        src_link: int,
        dst_link: Optional[int],
        nbytes: int,
        on_complete: Completion,
        *,
        extra_latency: float = 0.0,
        bw_scale: float = 1.0,
        tenant: Optional[str] = None,
        tag: object = None,
    ) -> int:
        """Post one wire operation. Returns op id. Completion is delivered
        through the event loop (success or failure). `tenant` names the
        posting engine when several share this fabric (per-tenant byte
        accounting; the wire semantics are tenant-blind). With `tag`, the
        completion is invoked as `on_complete(tag, ok, t0, t1, err)` so many
        ops can share one callback object (no per-op closure)."""
        op = WireOp(
            op_id=next(_op_ids), src_link=src_link, dst_link=dst_link,
            nbytes=nbytes, extra_latency=extra_latency, on_complete=on_complete,
            tenant=tenant, tag=tag,
        )
        src = self.links[src_link]
        dst = self.links[dst_link] if dst_link is not None else None

        if src.is_failed(self.now) or (dst is not None and dst.is_failed(self.now)):
            # Immediate error completion after the detection delay.
            op.failed = True
            self.call_after(
                self.FAIL_DETECT_LATENCY, partial(self._deliver_reject, op))
            return op.op_id

        start = max(self.now, src.busy_until, dst.busy_until if dst else 0.0)
        bw = src.effective_bandwidth(start)
        if dst is not None:
            bw = min(bw, dst.effective_bandwidth(start))
        service = nbytes / (bw * bw_scale)
        if src.jitter > 0:
            service *= float(1.0 + abs(src.rng.normal(0.0, src.jitter)))
        lat = src.desc.base_latency + extra_latency
        # the link is busy for the serialization time only; propagation and
        # submission latency pipeline with the next op (real NICs/DMA do)
        busy_end = start + service
        end = busy_end + lat
        op.start, op.end = start, end
        src.busy_until = busy_end
        if dst is not None:
            dst.busy_until = busy_end
        src.outstanding[op.op_id] = op
        if dst is not None:
            dst.outstanding[op.op_id] = op
        self.call_at(end, op)  # op entry == its own completion event
        return op.op_id

    def post_many(
        self,
        specs: Iterable[PostSpec],
        on_complete: Callable,
        *,
        tenant: Optional[str] = None,
    ) -> None:
        """Post a wave of wire operations sharing one tagged completion
        callback: `on_complete(tag, ok, t0, t1, err)` fires once per op.
        Each spec is (src_link, dst_link, nbytes, extra_latency, bw_scale,
        tag). Semantically identical to posting the specs one by one — same
        busy-chain serialization, same jitter-draw order, same event order —
        but with the per-op overheads hoisted out of the loop: no caller
        closures, no per-op attribute lookups, one inlined fast path per op
        (paper §4.4's batched posting). This loop must stay in lockstep with
        `post`; the wave-vs-scalar bit-identity regression pins that.
        """
        specs = list(specs)
        links = self.links
        events = self._events
        cal = self._cal
        seq = self._seq
        now = self.now
        detect = self.FAIL_DETECT_LATENCY

        # Wave-constant precomputation. Failure status only depends on `now`,
        # so one check per distinct link covers the whole wave; and because a
        # seeded numpy Generator yields the same stream batched or one draw
        # at a time, each source link's jitter samples for the wave can be
        # drawn in one call and consumed in post order — the draw sequence
        # every link observes is bit-identical to one-by-one posting.
        failed: Dict[int, bool] = {}
        jitter_counts: Dict[int, int] = {}
        for spec in specs:
            src_link, dst_link = spec[0], spec[1]
            f = failed.get(src_link)
            if f is None:
                f = failed[src_link] = links[src_link].is_failed(now)
            if dst_link is not None:
                fd = failed.get(dst_link)
                if fd is None:
                    fd = failed[dst_link] = links[dst_link].is_failed(now)
                f = f or fd
            if not f and links[src_link].jitter > 0:
                jitter_counts[src_link] = jitter_counts.get(src_link, 0) + 1
        jitter_draws = {
            lid: iter(links[lid].rng.normal(0.0, links[lid].jitter, size=cnt))
            for lid, cnt in jitter_counts.items()
        }

        for spec in specs:
            src_link, dst_link, nbytes, extra_latency, bw_scale, tag = spec
            op = WireOp(
                next(_op_ids), src_link, dst_link, nbytes, extra_latency,
                on_complete, 0.0, 0.0, False, False, tenant, tag,
            )
            src = links[src_link]
            dst = links[dst_link] if dst_link is not None else None

            if failed[src_link] or (dst is not None and failed[dst_link]):
                op.failed = True
                entry = (now + detect, next(seq), partial(self._deliver_reject, op))
                if cal is None:
                    heapq.heappush(events, entry)
                else:
                    cal.push(entry)
                continue

            start = max(now, src.busy_until, dst.busy_until if dst else 0.0)
            bw = src.effective_bandwidth(start)
            if dst is not None:
                bw = min(bw, dst.effective_bandwidth(start))
            service = nbytes / (bw * bw_scale)
            if src.jitter > 0:
                service *= float(1.0 + abs(next(jitter_draws[src_link])))
            lat = src.desc.base_latency + extra_latency
            busy_end = start + service
            end = busy_end + lat
            op.start, op.end = start, end
            src.busy_until = busy_end
            if dst is not None:
                dst.busy_until = busy_end
            src.outstanding[op.op_id] = op
            if dst is not None:
                dst.outstanding[op.op_id] = op
            if cal is None:
                heapq.heappush(events, (max(end, now), next(seq), op))
            else:
                cal.push((max(end, now), next(seq), op))

    def _complete(self, op: WireOp) -> None:
        if op.cancelled:
            return
        # A failure window may have opened after posting but before completion.
        src = self.links[op.src_link]
        dst = self.links[op.dst_link] if op.dst_link is not None else None
        mid_fail = any(
            l.is_failed(op.end) or l.is_failed(op.start)
            for l in ([src] + ([dst] if dst else []))
        )
        self._release(op)
        if mid_fail:
            src.ops_failed += 1
            self._deliver(op, False, op.start, self.now, "LinkFailed")
            return
        src.bytes_completed += op.nbytes
        src.ops_completed += 1
        if op.tenant is not None:
            src.bytes_by_tenant[op.tenant] = src.bytes_by_tenant.get(op.tenant, 0) + op.nbytes
        self._deliver(op, True, op.start, self.now, "")

    def _complete_batch(self, ops: List[WireOp], sink: CompletionSink) -> None:
        """Per-op completion accounting for one same-timestamp batch, then a
        single sink call. Semantically `_complete` run over the batch in heap
        order, with delivery deferred to the end: the per-op bookkeeping
        (mid-failure detection, release, byte counters) touches no state a
        later op's bookkeeping reads, and anything the sink posts lands at a
        strictly later (or later-seq same-time) heap position than every op
        already in this batch — so deferral cannot reorder the simulation.
        The only hoisted work is the failure-window probe: links with no
        schedule at all (the common case) skip the window scan entirely."""
        now = self.now
        links = self.links
        out = None  # lazily diverges from `ops` only when cancelled ops hide
        for idx, op in enumerate(ops):
            if op.cancelled:
                # aborted by a link failure; its delivery is already queued
                if out is None:
                    out = ops[:idx]
                continue
            if out is not None:
                out.append(op)
            src = links[op.src_link]
            dst = links[op.dst_link] if op.dst_link is not None else None
            if src.failed or src.fail_windows or (
                    dst is not None and (dst.failed or dst.fail_windows)):
                mid_fail = any(
                    l.is_failed(op.end) or l.is_failed(op.start)
                    for l in ([src] + ([dst] if dst else []))
                )
            else:
                mid_fail = False
            src.outstanding.pop(op.op_id, None)
            if dst is not None:
                dst.outstanding.pop(op.op_id, None)
            if mid_fail:
                src.ops_failed += 1
                op.failed = True
            else:
                src.bytes_completed += op.nbytes
                src.ops_completed += 1
                if op.tenant is not None:
                    src.bytes_by_tenant[op.tenant] = (
                        src.bytes_by_tenant.get(op.tenant, 0) + op.nbytes)
        if out is None:
            out = ops
        if out:
            sink(out, now)

    def _release(self, op: WireOp) -> None:
        self.links[op.src_link].outstanding.pop(op.op_id, None)
        if op.dst_link is not None:
            self.links[op.dst_link].outstanding.pop(op.op_id, None)

    # -- introspection -----------------------------------------------------------
    def link(self, link_id: int) -> LinkState:
        return self.links[link_id]

    def bytes_by_link(self) -> Dict[int, int]:
        return {i: l.bytes_completed for i, l in self.links.items()}

    def bytes_by_tenant(self) -> Dict[str, int]:
        """Completed bytes per posting engine across all links (multi-engine
        clusters share one fabric; this splits the wire traffic by owner)."""
        out: Dict[str, int] = {}
        for l in self.links.values():
            for tenant, b in l.bytes_by_tenant.items():
                out[tenant] = out.get(tenant, 0) + b
        return out
