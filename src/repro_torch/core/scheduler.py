"""Slice scheduling policies.

`TentPolicy` implements the paper's Algorithm 1 (telemetry-driven slice
scheduling) exactly: score every reachable candidate with the predictive
cost model times a topology-tier penalty, keep the candidates within a
tolerance window gamma of the best score, and round-robin among them; then
charge the chosen device's local queue.

The baseline policies reproduce the engines the paper compares against:
  * RoundRobinPolicy  — Mooncake TE's state-blind fixed-size striping (§2.2)
  * HashPolicy        — Mooncake TE's hashing variant
  * StaticBest2Policy — NIXL/UCX: stripe across the statically best K NICs
  * PinnedPolicy      — UCCL-P2P: each memory region is bound to one NIC

All policies share the same interface so the engine (and TEBench) can swap
them without touching anything else — that swap *is* the paper's ablation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .telemetry import LinkTelemetry, TelemetryStore
from .topology import DEFAULT_TIER_PENALTY
from .types import NO_ELIGIBLE_DEVICE, TentError


@dataclasses.dataclass
class Candidate:
    """One schedulable device (local link) with its affinity tier and, for
    two-resource paths, the remote endpoint's telemetry. The remote side
    carries the cluster-level signals: diffused receiver load and failure
    rumors from peer engines (paper §4.2)."""

    telemetry: LinkTelemetry
    tier: int
    remote: Optional[LinkTelemetry] = None

    @property
    def link_id(self) -> int:
        return self.telemetry.desc.link_id


class Policy:
    name = "abstract"

    def choose(self, candidates: Sequence[Candidate], length: int) -> Candidate:
        raise NotImplementedError

    def reset(self) -> None:  # pragma: no cover - most policies are stateless
        pass


class TentPolicy(Policy):
    """Algorithm 1: Telemetry-Driven Slice Scheduling."""

    name = "tent"

    def __init__(
        self,
        *,
        tier_penalty: Optional[Dict[int, float]] = None,
        gamma: float = 0.05,
        store: Optional[TelemetryStore] = None,
    ):
        self.tier_penalty = dict(tier_penalty or DEFAULT_TIER_PENALTY)
        self.gamma = gamma
        self.store = store
        self._rr = 0

    def scores(self, candidates: Sequence[Candidate], length: int) -> List[float]:
        out = []
        for c in candidates:
            tl = c.telemetry
            if tl.excluded or (c.remote is not None and c.remote.excluded):
                # soft exclusion (paper §4.3); a remote exclusion typically
                # arrives as a failure rumor from a peer engine (§4.2)
                out.append(float("inf"))
                continue
            queued = (
                self.store.effective_queue(tl) if self.store is not None else float(tl.queued_bytes)
            )
            if self.store is not None and c.remote is not None:
                # diffused receiver-side pressure: other engines' in-flight
                # bytes converging on the remote endpoint this path pairs with
                queued += self.store.remote_pressure(c.remote.desc.link_id)
            t_hat = tl.beta0 + tl.beta1 * (queued + length) / tl.desc.bandwidth
            out.append(self.tier_penalty.get(c.tier, float("inf")) * t_hat)
        return out

    def choose(self, candidates: Sequence[Candidate], length: int) -> Candidate:
        if not candidates:
            raise TentError(NO_ELIGIBLE_DEVICE, "empty candidate set")
        s = self.scores(candidates, length)
        s_min = min(s)
        if s_min == float("inf"):
            # Soft exclusion must not deadlock: when every rail is excluded
            # (e.g. a single-link hop under degradation), fall back to the
            # cost model over tier-feasible rails, ignoring exclusion.
            s = [
                self.tier_penalty.get(c.tier, float("inf"))
                * (c.telemetry.beta0 + c.telemetry.beta1
                   * (c.telemetry.queued_bytes + length) / c.telemetry.desc.bandwidth)
                for c in candidates
            ]
            s_min = min(s)
            if s_min == float("inf"):
                raise TentError(NO_ELIGIBLE_DEVICE, "no tier-feasible candidates")
        window = [c for c, sc in zip(candidates, s) if sc <= (1 + self.gamma) * s_min]
        chosen = window[self._rr % len(window)]
        self._rr += 1
        chosen.telemetry.on_schedule(length)  # line 11: A_d* += L
        return chosen

    def choose_wave(self, sc, lengths):
        """Algorithm 1 over a whole wave of same-stage slices at once.

        `sc` is a `repro_torch.core.plan.StageCandidates` (the cached, array-
        annotated candidate set for one plan stage); `lengths` the pending
        slices' byte counts, in dispatch order. One gather per array pulls
        the candidates' live telemetry out of the store's struct-of-arrays
        state, `tent_choose_wave` replays the per-slice choose/charge
        sequence on those arrays (bit-identical to calling `choose` once per
        slice, including the round-robin counter and the sequential line-11
        queue charges), and one scatter writes the charged queues back.

        Returns `(choices, queued_at_schedule)`: per-slice candidate indices
        (-1 from the first slice with no tier-feasible rail onward — the
        engine routes those through the scalar substitution path) and the
        per-slice post-charge queue depths the completion-side EWMA update
        needs."""
        store = self.store
        slots = sc.local_slot
        excluded = store.excluded_arr[slots]
        if sc.remote_any:
            excluded = excluded | (sc.has_remote & store.excluded_arr[sc.remote_slot_safe])
        if store.global_weight > 0.0:
            glocal = store.foreign_load_array(sc.local_links)
            gremote = store.foreign_load_array(sc.remote_links)
        else:
            glocal = gremote = sc.zeros
        choices, queued_at, queued_out, rr = tent_choose_wave(
            store.queued_arr[slots], glocal, gremote, sc.bandwidth,
            store.beta0_arr[slots], store.beta1_arr[slots], sc.penalty,
            excluded, lengths, self._rr, self.gamma)
        store.queued_arr[slots] = queued_out  # line 11 charges, applied
        self._rr = rr
        return choices, queued_at

    def wave_inputs(self, sc) -> dict:
        """Pre-charge snapshot of everything `choose_wave` is about to read
        — the decision-provenance record the flight recorder (repro.obs)
        stores with each WAVE event. Must be taken *before* `choose_wave`
        runs (the line-11 charges mutate the queue array);
        `repro.obs.explain.replay_wave` re-runs Algorithm 1 on this snapshot
        and cross-checks that it reproduces the recorded choices exactly.
        Every array is a fresh copy (fancy-index gathers / explicit copies),
        so later simulation steps cannot retroactively rewrite history."""
        store = self.store
        slots = sc.local_slot
        excluded = store.excluded_arr[slots]
        if sc.remote_any:
            excluded = excluded | (sc.has_remote & store.excluded_arr[sc.remote_slot_safe])
        if store.global_weight > 0.0:
            glocal = store.foreign_load_array(sc.local_links)
            gremote = store.foreign_load_array(sc.remote_links)
        else:
            glocal = np.array(sc.zeros, dtype=np.float64)
            gremote = np.array(sc.zeros, dtype=np.float64)
        return {
            "queued": store.queued_arr[slots],
            "glocal": glocal,
            "gremote": gremote,
            "bandwidth": np.array(sc.bandwidth, dtype=np.float64),
            "beta0": store.beta0_arr[slots],
            "beta1": store.beta1_arr[slots],
            "penalty": np.array(sc.penalty, dtype=np.float64),
            "excluded": excluded,
            "rr": self._rr,
            "gamma": self.gamma,
            "local_links": list(sc.local_links),
            "remote_links": list(sc.remote_links),
        }


class RoundRobinPolicy(Policy):
    """Mooncake TE-style state-blind striping: fixed rotation over the rails
    permitted by static NUMA priority, ignoring congestion signals."""

    name = "round_robin"

    def __init__(self, *, max_tier: int = 3):
        self.max_tier = max_tier
        self._rr = 0

    def choose(self, candidates: Sequence[Candidate], length: int) -> Candidate:
        # state-blind: no exclusion filtering (TE has no telemetry loop)
        elig = [c for c in candidates if c.tier <= self.max_tier]
        if not elig:
            raise TentError(NO_ELIGIBLE_DEVICE, "no round-robin candidates")
        chosen = elig[self._rr % len(elig)]
        self._rr += 1
        chosen.telemetry.on_schedule(length)
        return chosen


class HashPolicy(Policy):
    """Static hashing on the slice ordinal (Mooncake TE hashing mode)."""

    name = "hash"

    def __init__(self) -> None:
        self._n = 0

    def choose(self, candidates: Sequence[Candidate], length: int) -> Candidate:
        elig = list(candidates)  # state-blind
        if not elig:
            raise TentError(NO_ELIGIBLE_DEVICE, "no hash candidates")
        self._n += 1
        idx = (self._n * 2654435761) % len(elig)
        chosen = elig[idx]
        chosen.telemetry.on_schedule(length)
        return chosen


class StaticBest2Policy(Policy):
    """NIXL/UCX-style: rank NICs by static transport properties and stripe
    large transfers over the best K only; small blocks use a single NIC."""

    name = "static_best2"

    def __init__(self, *, k: int = 2, multirail_threshold: int = 8 * 1024 * 1024):
        self.k = k
        self.multirail_threshold = multirail_threshold
        self._rr = 0

    def choose(self, candidates: Sequence[Candidate], length: int) -> Candidate:
        elig = list(candidates)  # static transport properties only
        if not elig:
            raise TentError(NO_ELIGIBLE_DEVICE, "no static candidates")
        ranked = sorted(elig, key=lambda c: (c.tier, -c.telemetry.desc.bandwidth, c.link_id))
        if length < self.multirail_threshold:
            chosen = ranked[0]
        else:
            top = ranked[: self.k]
            chosen = top[self._rr % len(top)]
            self._rr += 1
        chosen.telemetry.on_schedule(length)
        return chosen


class PinnedPolicy(Policy):
    """UCCL-P2P-style: each registered region is pinned to exactly one NIC
    (its tier-1 / lowest-id rail); no cross-NIC aggregation."""

    name = "pinned"

    def choose(self, candidates: Sequence[Candidate], length: int) -> Candidate:
        elig = list(candidates)  # fixed region->NIC binding
        if not elig:
            raise TentError(NO_ELIGIBLE_DEVICE, "no pinned candidates")
        chosen = min(elig, key=lambda c: (c.tier, c.link_id))
        chosen.telemetry.on_schedule(length)
        return chosen


POLICIES = {
    p.name: p
    for p in (TentPolicy, RoundRobinPolicy, HashPolicy, StaticBest2Policy, PinnedPolicy)
}


def make_policy(name: str, **kwargs) -> Policy:
    try:
        return POLICIES[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; have {sorted(POLICIES)}") from None


# ---------------------------------------------------------------------------
# Vectorized wave scheduling (numpy, float64) — the engine's hot path.
#
# `tent_choose_wave` replays Algorithm 1 for a whole batch of pending slices
# against one candidate set. Per slice it performs the *same* float64
# operations, in the same order, as the scalar `TentPolicy.choose`, so the
# two paths pick bit-identical rails; the speedup comes from scoring all
# rails with a few array operations and never materializing per-slice
# candidate objects. Line 11's sequential queue charge is preserved by
# carrying the integer queue vector through the batch (`queued` evolves
# slice by slice; the omega-blended global terms are frozen for the wave —
# no event can change them while the dispatch loop runs).
# ---------------------------------------------------------------------------

def tent_choose_wave(queued, global_local, global_remote, bandwidth, beta0,
                     beta1, penalty, excluded, lengths, rr, gamma=0.05):
    """Batched Algorithm 1 on one candidate set (numpy float64 reference).

    Arguments are per-candidate arrays: integer local queues (bytes), the
    omega-discounted local/remote global-load terms, nominal bandwidth, the
    Eq. 1 betas, tier penalties (inf = tier-infeasible), and the soft-
    exclusion mask; `lengths` holds the wave's slice sizes in dispatch
    order, `rr` the policy's round-robin counter.

    Returns `(choices, queued_at_schedule, queued_out, rr_out)`. A slice
    whose candidates are all tier-infeasible gets choice -1 and *stops the
    wave* (entries from there on stay -1, uncharged) — feasibility is a
    static property of the candidate set, so every later slice of the wave
    would fail the same way and must go through the scalar substitution
    path instead.
    """
    # Work on plain Python floats/ints: every operation below is the same
    # IEEE-double operation, in the same order, that the scalar path
    # performs, and at rail counts of ~8 the interpreter beats per-op numpy
    # dispatch. The win over calling `choose` per slice is *incremental
    # rescoring*: after slice k charges rail c, only s[c] changes for slice
    # k+1 (as long as the slice length is unchanged — elephant decomposition
    # yields at most two distinct lengths per wave), so the steady state does
    # O(1) float work per slice plus one min/window scan.
    q = [int(v) for v in np.asarray(queued)]
    gl = [float(v) for v in np.asarray(global_local, dtype=np.float64)]
    gr = [float(v) for v in np.asarray(global_remote, dtype=np.float64)]
    bw = [float(v) for v in np.asarray(bandwidth, dtype=np.float64)]
    b0 = [float(v) for v in np.asarray(beta0, dtype=np.float64)]
    b1 = [float(v) for v in np.asarray(beta1, dtype=np.float64)]
    pen = [float(v) for v in np.asarray(penalty, dtype=np.float64)]
    exc = [bool(v) for v in np.asarray(excluded)]
    lens = [int(v) for v in np.asarray(lengths)]
    n_cands = len(q)
    n = len(lens)
    choices = np.full(n, -1, dtype=np.int64)
    queued_at = np.zeros(n, dtype=np.int64)
    inf = float("inf")
    one_plus_gamma = 1.0 + gamma
    rails = range(n_cands)

    def score(d: int, length: int) -> float:
        # same association order as the scalar path: (A + gl) + gr, then +L
        return pen[d] * (b0[d] + b1[d] * (((q[d] + gl[d]) + gr[d]) + length) / bw[d])

    s: list = []
    cur_len = None
    for k in range(n):
        length = lens[k]
        if length != cur_len:
            cur_len = length
            s = [inf if exc[d] else score(d, length) for d in rails]
        s_min = min(s)
        if s_min == inf:
            # soft exclusion must not deadlock (see TentPolicy.choose):
            # re-score the raw local cost model ignoring exclusion
            fb = [pen[d] * (b0[d] + b1[d] * (q[d] + length) / bw[d]) for d in rails]
            fb_min = min(fb)
            if fb_min == inf:
                break  # tier-infeasible: this and all later slices are -1
            window = [d for d in rails if fb[d] <= one_plus_gamma * fb_min]
            chosen = window[rr % len(window)]
            rr += 1
            q[chosen] += length  # line 11: A_d* += L
            if not exc[chosen]:
                s[chosen] = score(chosen, length)
        else:
            threshold = one_plus_gamma * s_min
            window = [d for d in rails if s[d] <= threshold]
            chosen = window[rr % len(window)]
            rr += 1
            q[chosen] += length  # line 11: A_d* += L
            s[chosen] = score(chosen, length)  # only the charged rail moved
        choices[k] = chosen
        queued_at[k] = q[chosen]
    return choices, queued_at, np.asarray(q, dtype=np.int64), rr
