"""Metrics registry: counters, gauges, and histograms on the virtual clock.

This replaces the ad-hoc counter plumbing between engine, cluster, and
scenario runner: instead of each runner branch hand-assembling an `extra`
dict from engine attributes, subsystems *register* their metrics once
(`TentEngine.register_metrics`, `TentCluster.register_metrics`) and the
runner calls `collect()` — one code path for all three workload kinds.

Design constraints, in order:

- **Zero hot-path cost.** Engines keep their plain integer attributes
  (`self.waves += 1` stays a bare int add); the registry reads them lazily
  through gauge callables at `collect()` time. Nothing here runs while the
  simulation is stepping.
- **Deterministic order.** `collect()` returns keys in registration order
  (gauge groups expand in their producer's dict order), so reports built
  from the registry are byte-identical to hand-built dicts.
- **Virtual-clock timestamps.** The registry can hold a clock callable
  (e.g. `lambda: fabric.now`); `timestamped()` pairs a collection with the
  virtual time it was taken, and histogram observations may carry one.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class Counter:
    """A monotonically increasing value (explicit `inc`, not sampled)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Value distribution; observations optionally timestamped."""

    __slots__ = ("name", "_values", "_ts")

    def __init__(self, name: str):
        self.name = name
        self._values: List[float] = []
        self._ts: List[float] = []

    def observe(self, value: float, ts: Optional[float] = None) -> None:
        self._values.append(float(value))
        if ts is not None:
            self._ts.append(float(ts))

    @property
    def count(self) -> int:
        return len(self._values)

    def summary(self) -> Dict[str, float]:
        if not self._values:
            return {f"{self.name}_count": 0.0}
        arr = np.asarray(self._values)
        return {
            f"{self.name}_count": float(arr.size),
            f"{self.name}_mean": float(arr.mean()),
            f"{self.name}_p50": float(np.percentile(arr, 50)),
            f"{self.name}_p99": float(np.percentile(arr, 99)),
        }


class MetricsRegistry:
    """Ordered registry; `collect()` flattens everything to name -> float."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock
        # (kind, producer) in registration order; kinds: counter | gauge |
        # group | histogram
        self._entries: List[Tuple[str, object]] = []
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
            self._entries.append(("counter", c))
        return c

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        self._entries.append(("gauge", (name, fn)))

    def gauge_group(self, fn: Callable[[], Dict[str, float]]) -> None:
        """A callable producing an ordered dict of name -> value. Lets one
        producer emit several related gauges from a single snapshot (the
        cluster reads its engine-summed counters once, not once per key)."""
        self._entries.append(("group", fn))

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
            self._entries.append(("histogram", h))
        return h

    def collect(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for kind, entry in self._entries:
            if kind == "counter":
                out[entry.name] = float(entry.value)
            elif kind == "gauge":
                name, fn = entry
                out[name] = float(fn())
            elif kind == "group":
                for name, value in entry().items():
                    out[name] = float(value)
            else:  # histogram
                out.update(entry.summary())
        return out

    def timestamped(self) -> Tuple[float, Dict[str, float]]:
        now = float(self._clock()) if self._clock is not None else 0.0
        return now, self.collect()
