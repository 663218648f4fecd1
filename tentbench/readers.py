"""Arithmetic the metric readers share. Each reader returns None where the
run holds nothing for it to read; a share of a peak is never made up."""
from __future__ import annotations

import statistics
from collections import Counter
from typing import Callable, Optional

from . import peaks


def ttft_ms(run) -> list:
    """Every request's time to first token; a call's rows share it."""
    return [c.ttft_s * 1e3 for c in run.calls for _ in range(c.batch)]


def percentile(values: list, p: int) -> Optional[float]:
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[p - 1]


def span_mean_ms(run, *names: str) -> Optional[float]:
    """The mean over the window's calls of the named spans' sum."""
    if not run.calls:
        return None
    return sum(c.spans.get(n, 0.0) for c in run.calls for n in names) / len(run.calls) * 1e3


def idle_pct(run) -> Optional[float]:
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(run) -> Optional[float]:
    if not run.calls or run.window_s <= 0:
        return None
    work = sum(run.flops(c) for c in run.calls)
    return 100.0 * work / (run.window_s * peaks.FLOPS[run.cell.dtype])


def roofline_pct(run, op: str, bound: Callable[[tuple], float]) -> Optional[float]:
    """Sum of the op's bounds over the sum of its device time, over the
    traced calls whose range holds as many kernel records as most calls'
    do: a call missing a record (CUPTI drops some) is left out whole."""
    if run.trace is None or run.op_calls is None:
        return None
    shapes, times = run.op_calls.get(op, []), run.trace.ranges.get(op, [])
    if not shapes or len(shapes) != len(times):
        return None
    counts = Counter(n for _, n in times if n > 0)
    if not counts:
        return None
    modal = counts.most_common(1)[0][0]
    kept = [(shape, ns) for shape, (ns, n) in zip(shapes, times) if n == modal]
    device_ms = sum(ns for _, ns in kept) / 1e6
    return 100.0 * sum(bound(shape) for shape, _ in kept) / device_ms if device_ms > 0 else None
