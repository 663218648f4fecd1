"""Seeded arrival-stream generation: the one source of truth for workload
shape across scenarios, benchmarks, and examples.

Production serving traffic has two statistical signatures the paper's
Table 2 microbenchmarks don't exercise: Poisson arrivals (open-loop — the
world does not wait for the server) and Zipfian popularity over prefix
groups (a few system prompts / hot conversations dominate, a long tail
misses every cache). `TrafficSpec.generate()` derives both from one seed;
the same spec therefore reproduces the same stream in the
`serving_production_stream` scenario, in `benchmarks/serving_scale.py`,
and in any example — and the determinism is pinned by
tests/test_traffic.py (same seed => identical arrays).

`promotion_bytes` folds the stream through the vectorized KV-residency
model the batched serving loop uses: a group's prefix KV stays GPU-resident
for `resident_s` after its last use, so hot Zipf groups re-hit for free
while the tail pays a store->GPU promotion — the transfer-bound elephant
flows TENT sprays. It lives here (not in the simulator) because the jitted
sweep lowering needs the same per-request byte schedule without building a
simulator.

`conversation_tokens` is the legacy multi-turn token-id generator the
sync/async `ServingSimulator` modes and `benchmarks/serving_closed_loop.py`
share (it used to be inlined in each).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

__all__ = [
    "TrafficSpec",
    "TrafficStream",
    "conversation_tokens",
    "promotion_bytes",
]


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Declarative request-stream shape. JSON round-trippable like the rest
    of the scenario vocabulary."""

    requests: int
    arrival_rate: float  # mean arrivals/s (Poisson process)
    zipf_alpha: float = 1.1  # popularity skew over prefix groups
    groups: int = 64  # distinct prefix groups (system prompts / convos)
    input_tokens: int = 1024  # mean prompt length
    output_tokens: int = 64  # decode length (fixed per request)
    input_jitter: float = 0.25  # relative spread of prompt lengths
    seed: int = 0

    def __post_init__(self) -> None:
        if self.requests < 0:
            raise ValueError("requests must be >= 0")
        if self.requests > 0 and self.arrival_rate <= 0:
            raise ValueError("arrival_rate must be > 0")
        if self.zipf_alpha <= 0 or self.groups < 1:
            raise ValueError("need zipf_alpha > 0 and groups >= 1")

    def generate(self) -> "TrafficStream":
        n = self.requests
        rng = np.random.default_rng(self.seed)
        if n == 0:
            z = np.zeros(0)
            return TrafficStream(
                spec=self, arrival=z, group=z.astype(np.int64),
                input_tokens=z.astype(np.int64),
                output_tokens=z.astype(np.int64))
        arrival = np.cumsum(rng.exponential(1.0 / self.arrival_rate, size=n))
        ranks = np.arange(1, self.groups + 1, dtype=np.float64)
        weights = ranks ** -self.zipf_alpha
        weights /= weights.sum()
        group = rng.choice(self.groups, size=n, p=weights).astype(np.int64)
        itok = np.maximum(
            16,
            np.rint(self.input_tokens *
                    (1.0 + self.input_jitter * rng.standard_normal(n))),
        ).astype(np.int64)
        otok = np.full(n, self.output_tokens, dtype=np.int64)
        return TrafficStream(
            spec=self, arrival=arrival, group=group,
            input_tokens=itok, output_tokens=otok)

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class TrafficStream:
    """One generated stream: parallel per-request arrays, arrival-sorted."""

    spec: TrafficSpec
    arrival: np.ndarray  # float64 (N,) seconds from stream start
    group: np.ndarray  # int64 (N,) prefix-group id
    input_tokens: np.ndarray  # int64 (N,)
    output_tokens: np.ndarray  # int64 (N,)

    def __len__(self) -> int:
        return int(self.arrival.shape[0])


def promotion_bytes(stream: TrafficStream, *, prefix_frac: float,
                    kv_bytes_per_token: int,
                    resident_s: float) -> np.ndarray:
    """Per-request store->GPU promotion bytes under the group-residency
    model: a request promotes its group's prefix KV (`prefix_frac` of its
    prompt, in `kv_bytes_per_token` units) iff the group is cold — first
    appearance, or more than `resident_s` since the group's previous
    request evicted it from GPU HBM. Pure function of the stream, so the
    scheduler-independent byte schedule can also be lowered into the jitted
    sweep skeleton."""
    n = len(stream)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.lexsort((stream.arrival, stream.group))
    g = stream.group[order]
    a = stream.arrival[order]
    cold = np.empty(n, dtype=bool)
    cold[0] = True
    same = g[1:] == g[:-1]
    cold[1:] = ~same | ((a[1:] - a[:-1]) > resident_s)
    promote = np.empty(n, dtype=bool)
    promote[order] = cold
    prefix_tokens = np.rint(stream.input_tokens * prefix_frac).astype(np.int64)
    return np.where(promote, prefix_tokens * int(kv_bytes_per_token),
                    0).astype(np.int64)


def conversation_tokens(clients: int, turns: int, input_tokens: int,
                        seed: int) -> Dict[int, List[int]]:
    """Per-client multi-turn token-id streams for the sync/async serving
    modes: client `c` holds `turns * input_tokens` token ids; turn `k`
    prefixes the first `k * input_tokens` of them (shared history => HiCache
    prefix hits). One seeded generator for all clients keeps the draw order
    stable however the caller iterates."""
    rng = np.random.default_rng(seed)
    return {
        c: rng.integers(1, 50_000, size=turns * input_tokens).tolist()
        for c in range(clients)
    }
