"""Spans, op ranges and the device trace of one run.

Spans are taken by the harness around its calls into each layer (host
clock, `time.perf_counter`); with tracing on, each span is also a
`record_function` range, so the profiler's trace names what the host was
doing when the device sat idle. Tracing also wraps the model's attention
and SSD-scan calls in ranges of their own and records each call's shapes:
the device time of the kernels launched inside a range is that op's time,
whatever kernels implement it.

The trace is read from the profiler's raw event list (CUPTI through
kineto), not from its per-op tables. CUPTI has been seen to return fewer
kernel records than launches, so the reader counts both.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional

import torch

SPANS = ("prefill", "pack", "engine", "unpack", "decode")
OPS = ("attention", "ssd")
PREFIX = "tb."
TOP = 10


class Spans:
    """Host spans of one call: name -> seconds."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(PREFIX + name) if self.traced else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


class OpRanges:
    """Wraps the model's attention and SSD-scan entries in ranges and
    records each call's shapes; `restore` puts the entries back."""

    def __init__(self):
        from repro_torch.models import model as model_mod
        from repro_torch.models import ssm as ssm_mod

        self.calls: Dict[str, List[tuple]] = {name: [] for name in OPS}
        self._saved = [(model_mod, "prefill_attention", model_mod.prefill_attention),
                       (ssm_mod, "ssd_chunked", ssm_mod.ssd_chunked)]
        attn, ssd = model_mod.prefill_attention, ssm_mod.ssd_chunked

        def attention(q, k, v, *, window=0, use_pallas=False):
            with torch.profiler.record_function(PREFIX + "attention"):
                out = attn(q, k, v, window=window, use_pallas=use_pallas)
            B, S, H, D = q.shape
            self.calls["attention"].append((B, S, H, k.shape[2], D, q.dtype, window))
            return out

        def ssd_chunked(x, a, B, C, *, chunk, initial_state=None, use_pallas=False):
            with torch.profiler.record_function(PREFIX + "ssd"):
                out = ssd(x, a, B, C, chunk=chunk, initial_state=initial_state,
                          use_pallas=use_pallas)
            b, s, h, p = x.shape
            self.calls["ssd"].append((b, s, h, p, B.shape[-1], chunk, x.dtype,
                                      initial_state is not None))
            return out

        model_mod.prefill_attention = attention
        ssm_mod.ssd_chunked = ssd_chunked

    def clear(self) -> None:
        for calls in self.calls.values():
            calls.clear()

    def restore(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class Trace:
    """What the profiler saw over the window."""

    def __init__(self, busy_s, window_s, device_ops, idle_gaps, ranges, records):
        self.busy_s = busy_s  # union of device activity
        self.window_s = window_s
        self.device_ops = device_ops  # [[name, seconds]], the top TOP
        self.idle_gaps = idle_gaps  # [[host span, seconds of device idle]], the top TOP
        self.ranges = ranges  # op -> [(device ns, kernel records)] a call, in call order
        self.records = records  # counts of kernel records, launches and matches


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name or name.startswith("cudaMemcpy") or name.startswith("cudaMemset")


def read_trace(prof, window_s: float) -> Trace:
    from torch.autograd import DeviceType

    dev = []  # (start, end, name, correlation)
    host = defaultdict(list)  # span or op name -> [(start, end)]
    launch_at: Dict[int, int] = {}
    launches = 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(PREFIX):
                continue
            dev.append((start, start + e.duration_ns(), name, e.correlation_id()))
        elif name.startswith(PREFIX):
            host[name[len(PREFIX):]].append((start, start + e.duration_ns()))
        elif _is_launch(name):
            launches += 1
            launch_at[e.correlation_id()] = start
    dev.sort()
    spans = sorted((s, t, n) for n in SPANS for s, t in host.get(n, ()))
    lo = spans[0][0] if spans else (dev[0][0] if dev else 0)
    hi = max((t for _, t, _ in spans), default=dev[-1][1] if dev else 0)

    # the union of device activity, and its gaps inside the window
    busy, gaps, cur_s, cur_e = 0, [], None, lo
    by_name = Counter()
    for s, t, name, _ in dev:
        by_name[name] += t - s
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        if cur_s is None or s > cur_e:
            if s > cur_e:
                gaps.append((cur_e, s))
            if cur_s is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_s is not None:
        busy += cur_e - cur_s
    if cur_e < hi:
        gaps.append((cur_e, hi))

    idle = Counter()
    starts = [s for s, _, _ in spans]
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        idle[spans[i][2] if i >= 0 and spans[i][1] >= mid else "between"] += g1 - g0

    ranges = {}
    for op in OPS:
        occ = sorted(host.get(op, ()))
        op_starts = [s for s, _ in occ]
        acc = [[0, 0] for _ in occ]
        for s, t, _, corr in dev:
            at = launch_at.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(op_starts, at) - 1
            if i >= 0 and at <= occ[i][1]:
                acc[i][0] += t - s
                acc[i][1] += 1
        ranges[op] = [tuple(a) for a in acc]
    matched = sum(1 for *_, corr in dev if corr in launch_at)
    return Trace(busy_s=busy / 1e9, window_s=window_s,
                 device_ops=[[n, ns / 1e9] for n, ns in by_name.most_common(TOP)],
                 idle_gaps=[[n, ns / 1e9] for n, ns in idle.most_common(TOP)],
                 ranges=ranges,
                 records={"device_records": len(dev), "launches": launches,
                          "records_matched_to_launches": matched,
                          "traced_span": (hi - lo) / 1e9})


class Profiler:
    """torch.profiler over the window, CPU and CUDA activity."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self._make = lambda: profile(activities=acts)
        self.prof: Optional[object] = None

    def warm(self) -> None:
        """Start and stop once, so that the window's start does not pay for
        the tracer's own set-up."""
        with self._make():
            torch.zeros(1, device=self.device)

    def start(self) -> None:
        self.prof = self._make()
        self.prof.__enter__()

    def stop(self, window_s: float) -> Trace:
        self.prof.__exit__(None, None, None)
        return read_trace(self.prof, window_s)
