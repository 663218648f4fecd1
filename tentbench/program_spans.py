"""Readers of the port's own host spans (`repro_torch.obs.spans`).

The harness times each layer from outside, around its calls into the port
(`tracing.Spans`, the `tb.*` ranges). With a `SpanRecorder` attached, the
port records spans of its own inside those calls: segment registration
and stage-in, TENT's submission and event loop with their dispatch, drain
and copy accumulators, the model's prefill and decode steps. These
readers take a run whose calls carry their spans on `Call.program` (each
call served in `request(keep=True)` and its spans `take`n) and whose
trace carries `read_program_trace`'s reading on `Trace.program`:

    segment_ms      serving.register + serving.stage_in, mean a call
    schedule_ms     engine.submit and the dispatches and drains inside
                    engine.run, less the copies inside them
    slice_copy_ms   the slices' byte copies inside engine.submit and engine.run
    fabric_ms       engine.run less its dispatches, drains and copies: the
                    simulated fabric's event loop
    copy_amp        host-to-host bytes copied in a call's spans over the
                    bytes it shipped
    decode_launches kernel, memcpy and memset launches inside each
                    `tent.model.decode_step` range (traced window)
    idle_by_program_span
                    device-idle seconds of the traced window under the
                    innermost `tent.*` range, and under each pair of
                    (`tb.*` span, innermost `tent.*` range)

The first four partition the harness's `engine` span, less the glue
between the port's calls (the flap's scheduling, `allocate_batch`,
`on_batch_done`). Every reader returns None for a run without program
spans. The benchmark's command attaches no recorder and keeps no
`Call.program` or `Trace.program` yet, so nothing it runs calls these
readers: they are the definitions its harness and metric readers are to
take over.
"""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Dict, List, Optional

PROGRAM_PREFIX = "tent."
HARNESS_PREFIX = "tb."
SEGMENT = ("serving.register", "serving.stage_in")


# ---------------------------------------------------------------------------
# readers of the calls' spans
# ---------------------------------------------------------------------------

def _total(spans, names, key: Optional[str] = None) -> int:
    """Summed nanoseconds (or counter `key`) of the spans named `names`."""
    return sum(s.ns if key is None else s.counters.get(key, 0)
               for s in spans if s.name in names)


def parts_ns(spans) -> Dict[str, int]:
    """One call's engine-side parts, in nanoseconds."""
    run = [s for s in spans if s.name == "engine.run"]
    run_acc = sum(_total(run, ("engine.run",), k) for k in ("dispatch_ns", "drain_ns"))
    submit_copy = _total(spans, ("engine.submit",), "copy_ns")
    run_copy = _total(run, ("engine.run",), "copy_ns")
    return {"segment": _total(spans, SEGMENT),
            "schedule": _total(spans, ("engine.submit",)) - submit_copy + run_acc,
            "slice_copy": submit_copy + run_copy,
            "fabric": _total(run, ("engine.run",)) - run_acc - run_copy}


def _calls(run) -> list:
    return [c for c in run.calls if getattr(c, "program", None)]


def _part_ms(run, part: str) -> Optional[float]:
    calls = _calls(run)
    if not calls:
        return None
    return sum(parts_ns(c.program)[part] for c in calls) / len(calls) / 1e6


def segment_ms(run) -> Optional[float]:
    return _part_ms(run, "segment")


def schedule_ms(run) -> Optional[float]:
    return _part_ms(run, "schedule")


def slice_copy_ms(run) -> Optional[float]:
    return _part_ms(run, "slice_copy")


def fabric_ms(run) -> Optional[float]:
    return _part_ms(run, "fabric")


def copy_amp(run) -> Optional[float]:
    calls = _calls(run)
    shipped = sum(c.kv_bytes for c in calls)
    if not calls or shipped <= 0:
        return None
    return sum(s.counters.get("copy_bytes", 0) for c in calls for s in c.program) / shipped


def segments_live(calls) -> Optional[Dict[str, int]]:
    """`segments_live` and `segment_bytes_live` of the last call's
    `serving.register`: the segments left registered as it served."""
    for c in reversed(calls):
        reg = [s for s in getattr(c, "program", None) or () if s.name == "serving.register"]
        if reg:
            return {k: reg[-1].counters[k] for k in ("segments_live", "segment_bytes_live")}
    return None


def span_means_ms(calls) -> Dict[str, float]:
    """Each program span's summed milliseconds, mean a call."""
    calls = [c for c in calls if getattr(c, "program", None)]
    total = Counter()
    for c in calls:
        for s in c.program:
            total[s.name] += s.ns
    return {name: ns / len(calls) / 1e6 for name, ns in sorted(total.items())}


# ---------------------------------------------------------------------------
# readers of the traced window's `tent.*` ranges
# ---------------------------------------------------------------------------

def _innermost(ranges: List[tuple]):
    """Breakpoints of the innermost of nested (start, end, name) ranges:
    sorted times, and the name in effect from each (None outside all)."""
    times, names, stack = [], [], []

    def pop_to(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            times.append(end)
            names.append(stack[-1][2] if stack else None)

    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        pop_to(s)
        stack.append((s, e, name))
        times.append(s)
        names.append(name)
    pop_to(float("inf"))
    return times, names


def _at(breaks, t):
    times, names = breaks
    i = bisect.bisect_right(times, t) - 1
    return names[i] if i >= 0 else None


def read_program_trace(events) -> Optional[dict]:
    """The `tent.*` ranges of a profiler's raw events (kineto's
    `events()`): the launches a decode step issues and the device's idle
    gaps put down to the innermost range. None where there is no `tent.*`
    range."""
    from torch.autograd import DeviceType

    from tentbench.tracing import SPANS, _is_launch

    program, harness, dev, launches = [], [], [], []
    for e in events:
        name, start = e.name(), e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith((HARNESS_PREFIX, PROGRAM_PREFIX))):
                dev.append((start, start + e.duration_ns()))
        elif name.startswith(PROGRAM_PREFIX):
            program.append((start, start + e.duration_ns(), name[len(PROGRAM_PREFIX):]))
        elif name.startswith(HARNESS_PREFIX) and name[len(HARNESS_PREFIX):] in SPANS:
            harness.append((start, start + e.duration_ns(), name[len(HARNESS_PREFIX):]))
        elif _is_launch(name):
            launches.append(start)
    if not program:
        return None
    out = {"ranges": dict(Counter(n for *_, n in program))}

    steps = sorted((s, t) for s, t, n in program if n == "model.decode_step")
    if steps:
        starts = [s for s, _ in steps]
        inside = 0
        for at in launches:
            i = bisect.bisect_right(starts, at) - 1
            inside += i >= 0 and at <= steps[i][1]
        out["decode_launches"] = inside / len(steps)

    # the device's idle gaps between the first and the last harness span
    # (the window), as the harness's own breakdown bounds them
    bounds = harness or program
    lo, hi = min(s for s, _, _ in bounds), max(t for _, t, _ in bounds)
    gaps, cur = [], lo
    for s, t in sorted(dev):
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if cur < hi:
        gaps.append((cur, hi))
    # each gap split over the pieces of the timeline by innermost range, so
    # a gap that spans several ranges is shared between them
    inner, outer = _innermost(program), _innermost(harness)
    cuts = sorted(set(inner[0]) | set(outer[0]) | {lo})
    pieces = [(t, _at(inner, t) or "outside", _at(outer, t) or "between") for t in cuts]
    starts = [t for t, _, _ in pieces]
    by_span, by_pair = defaultdict(int), defaultdict(int)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        while i < len(pieces) and pieces[i][0] < g1:
            p0 = max(g0, pieces[i][0])
            p1 = min(g1, pieces[i + 1][0]) if i + 1 < len(pieces) else g1
            if p1 > p0:
                by_span[pieces[i][1]] += p1 - p0
                by_pair[f"{pieces[i][2]}/{pieces[i][1]}"] += p1 - p0
            i += 1
    out["idle_by_program_span"] = {k: v / 1e9 for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])}
    out["idle_by_harness_and_program_span"] = {
        k: v / 1e9 for k, v in sorted(by_pair.items(), key=lambda kv: -kv[1])}
    return out


def _trace_reading(run, key):
    program = getattr(run.trace, "program", None) if run.trace is not None else None
    return program.get(key) if program else None


def decode_launches(run) -> Optional[float]:
    return _trace_reading(run, "decode_launches")


def idle_by_program_span(run) -> Optional[dict]:
    return _trace_reading(run, "idle_by_program_span")


READERS = {"segment_ms": segment_ms, "schedule_ms": schedule_ms, "slice_copy_ms": slice_copy_ms,
           "fabric_ms": fabric_ms, "copy_amp": copy_amp, "decode_launches": decode_launches}
