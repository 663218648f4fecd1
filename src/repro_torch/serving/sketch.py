"""Streaming percentile estimation (P² algorithm, Jain & Chlamtac 1985).

At 10^5-10^6 requests per scenario, keeping every TTFT/TPOT sample alive
just to call `np.percentile` at the end is an O(N) memory tax on the hot
loop — the request log grew unboundedly in async mode before
`ServeSimConfig.log_requests` gated it. A `P2Quantile` keeps five markers
(O(1) memory, O(1) update) and tracks one quantile; `PercentileSketch`
bundles the P50/P90/P99 trio plus exact count/mean/max. Below
`EXACT_THRESHOLD` observations the sketch returns exact order statistics
from its warm-up buffer (P² needs >= 5 samples to even initialize, and
small scenarios — the whole existing library — should keep their exact
percentiles bit-for-bit).

Deterministic given insertion order: no randomness, so the virtual clock's
reproducibility guarantee extends through the metrics path.
"""
from __future__ import annotations

from typing import List

__all__ = ["P2Quantile", "PercentileSketch", "EXACT_THRESHOLD"]

# Sketches report exact order statistics until this many samples have been
# observed; beyond it the P^2 markers take over. 1000 keeps every scenario
# in today's library exact while bounding the buffer.
EXACT_THRESHOLD = 1000


class P2Quantile:
    """Single-quantile P^2 estimator: five markers whose heights approximate
    the (0, q/2, q, (1+q)/2, 1) quantiles, nudged toward ideal positions by
    a piecewise-parabolic update on every observation."""

    __slots__ = ("q", "n", "heights", "pos", "want", "dpos")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self.n = 0
        self.heights: List[float] = []
        self.pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self.want = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
        self.dpos = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def add(self, x: float) -> None:
        self.n += 1
        h = self.heights
        if self.n <= 5:
            h.append(x)
            if self.n == 5:
                h.sort()
            return
        # locate the cell and bump marker positions above it
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        pos = self.pos
        for i in range(k + 1, 5):
            pos[i] += 1.0
        want = self.want
        for i in range(5):
            want[i] += self.dpos[i]
        # nudge the three interior markers toward their ideal positions
        for i in (1, 2, 3):
            d = want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
                    (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d >= 0 else -1.0
                hp = self._parabolic(i, d)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # parabolic estimate escaped; fall back to linear
                    j = i + int(d)
                    h[i] = h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, pos = self.heights, self.pos
        return h[i] + d / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + d) * (h[i + 1] - h[i]) /
            (pos[i + 1] - pos[i]) +
            (pos[i + 1] - pos[i] - d) * (h[i] - h[i - 1]) /
            (pos[i] - pos[i - 1]))

    def value(self) -> float:
        if self.n == 0:
            return 0.0
        if self.n <= 5:
            s = sorted(self.heights)
            # nearest-rank on the warm-up buffer
            idx = min(len(s) - 1, max(0, round(self.q * (len(s) - 1))))
            return s[int(idx)]
        return self.heights[2]


class PercentileSketch:
    """P50/P90/P99 + count/mean/max over one metric stream. Exact (buffered
    numpy percentile, linear interpolation — identical to the legacy log
    path) below EXACT_THRESHOLD samples, P^2 beyond."""

    __slots__ = ("count", "total", "max", "_buf", "_p2")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._buf: List[float] = []
        self._p2 = (P2Quantile(0.50), P2Quantile(0.90), P2Quantile(0.99))

    def add(self, x: float) -> None:
        self.count += 1
        self.total += x
        if x > self.max:
            self.max = x
        if self._buf is not None:
            self._buf.append(x)
            if len(self._buf) > EXACT_THRESHOLD:
                self._buf = None
        for p2 in self._p2:
            p2.add(x)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100], matching np.percentile's convention."""
        if self.count == 0:
            return 0.0
        if self._buf is not None:
            import numpy as np

            return float(np.percentile(np.asarray(self._buf), q))
        for p2 in self._p2:
            if abs(p2.q * 100.0 - q) < 1e-9:
                return p2.value()
        raise ValueError(
            f"P{q:g} not tracked beyond the exact buffer (have P50/P90/P99)")
