"""Phase 3: Proactive dual-layer resilience (paper §4.3).

Link layer: implicit (telemetry: predicted completion times growing vs
peers) and explicit (completion errors) signals drive *soft exclusion* —
the rail's cost becomes infinite and it leaves the candidate set without
heavyweight reconfiguration. A background prober sends lightweight
heartbeat slices to excluded rails and gradually re-admits responsive ones.

Transport layer: when a whole backend turns fatal, the orchestrator promotes
the next-best transport from the Phase-1 plan (backend substitution).

Slice layer: failures surface as per-slice errors; because slices write to
absolute destination offsets, re-execution is idempotent. Retries bypass the
predictive model and prioritize reliability (low tier, few failures), but
their bytes are still charged to the global queue statistics so recovery
traffic cannot starve unrelated flows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

from ..obs import events as OBS
from .scheduler import Candidate
from .telemetry import TelemetryStore


@dataclasses.dataclass
class HealthConfig:
    degrade_ratio: float = 4.0  # observed/predicted ratio that counts as slow
    degrade_min_time: float = 2e-3  # absolute floor: microsecond noise is not degradation
    degrade_consecutive: int = 3  # consecutive slow slices before exclusion
    probe_interval: float = 0.05  # seconds between heartbeat rounds
    probe_bytes: int = 64 * 1024  # lightweight heartbeat slice
    retry_limit: int = 8


class HealthMonitor:
    """Tracks rail health and drives exclusion / probing / re-admission."""

    def __init__(self, store: TelemetryStore, cfg: HealthConfig):
        self.store = store
        self.cfg = cfg
        self.exclusions = 0
        self.readmissions = 0
        # Cluster hooks: repro.cluster.ClusterMembership subscribes here to
        # turn one engine's local observation into a cluster-wide rumor.
        self.on_exclude: Callable[[int], None] | None = None
        self.on_readmit: Callable[[int], None] | None = None
        # flight recorder (repro.obs); attached with the owning engine's
        # clock and name so health transitions carry virtual timestamps
        self._rec = None
        self._clock = None
        self._owner = ""

    def attach_recorder(self, rec, clock, *, owner: str = "") -> None:
        self._rec = rec
        self._clock = clock
        self._owner = owner

    # -- implicit signal (paper: the telemetry loop naturally detects
    # struggling rails as predicted completion times grow) -------------------
    def observe(self, link_id: int, t_obs: float, t_pred: float) -> None:
        tl = self.store.maybe(link_id)
        if tl is None or tl.excluded:
            return
        if t_pred > 0 and t_obs > self.cfg.degrade_ratio * t_pred and t_obs > self.cfg.degrade_min_time:
            tl.consecutive_slow += 1
            if tl.consecutive_slow >= self.cfg.degrade_consecutive:
                self.exclude(link_id)
        else:
            tl.consecutive_slow = 0

    def observe_many(self, slots, link_ids, t_obs, t_pred) -> bool:
        """`observe` over one completion batch (store slots + link ids +
        observed/predicted times in drain order). The common all-healthy case
        is one vectorized predicate plus one scatter (reset the slow streaks
        of the non-excluded rails); as soon as any sample trips the slow
        predicate the whole batch falls back to per-item `observe` in exact
        order, because consecutive-slow streaks and the exclusion they
        escalate into are order-sensitive. Returns True when any of the
        batch's rails is excluded afterwards (the engine's cue to arm the
        probe timer, exactly like the per-item `tl.excluded` check)."""
        store = self.store
        excluded = store.excluded_arr[slots]
        cfg = self.cfg
        slow = (t_pred > 0) & (t_obs > cfg.degrade_ratio * t_pred) \
            & (t_obs > cfg.degrade_min_time) & ~excluded
        if not slow.any():
            live = ~excluded
            store.slow_arr[slots[live] if not live.all() else slots] = 0
            return bool(excluded.any())
        for lid, to, tp in zip(link_ids, t_obs, t_pred):
            self.observe(lid, float(to), float(tp))
        return bool(store.excluded_arr[slots].any())

    # -- explicit signal (completion failures / timeouts) ---------------------
    def on_explicit_failure(self, link_id: int) -> None:
        tl = self.store.maybe(link_id)
        if tl is not None:
            tl.on_failure()
        self.exclude(link_id, explicit=True)

    def on_path_failure(self, local_link: int, remote_link: int | None) -> None:
        """A wire path died. The engine cannot tell which side failed, so
        both endpoints become suspects: the local rail leaves the candidate
        set as before, and the remote endpoint is soft-excluded too, which
        keeps *other* local rails pairing with it out of the spray. Both are
        probed and re-admitted independently."""
        self.on_explicit_failure(local_link)
        if remote_link is not None:
            self.exclude(remote_link, explicit=True)

    def exclude(self, link_id: int, *, explicit: bool = False) -> bool:
        """Soft exclusion. Only *explicit* failures are worth a cluster
        rumor: a wire error is a fact about the link, while an implicit
        (slow-rail) exclusion is one engine's congestion estimate — that
        signal already travels through the global load table, and gossiping
        it too makes every engine herd off rails that are merely busy.

        The rumor hook fires on *every* explicit failure, even when the link
        is already excluded: an implicit exclusion escalating to a wire
        error is news the cluster has not heard yet (the membership layer
        deduplicates repeat rumors for the same outage).

        Returns True when the link's exclusion state actually changed."""
        tl = self.store.maybe(link_id)
        if tl is None:
            return False
        changed = not tl.excluded
        if changed:
            tl.excluded = True
            self.exclusions += 1
            rec = self._rec
            if rec is not None:
                rec.append(OBS.EXCLUDE, self._clock.now, {
                    "engine": self._owner, "link": link_id,
                    "explicit": explicit})
        elif not explicit:
            return False
        if explicit and self.on_exclude is not None:
            self.on_exclude(link_id)
        return changed

    def readmit(self, link_id: int, *, verified: bool = False) -> bool:
        """Re-admit an excluded rail. Only *verified* readmissions (a probe
        actually succeeded, `verified=True`) are gossiped to the cluster —
        the periodic state reset re-admits blindly by design, and blindly
        clearing a failure rumor cluster-wide mid-outage would make every
        engine take the same failure storm at once.

        Returns True when the link was actually re-admitted."""
        tl = self.store.maybe(link_id)
        if tl is not None and tl.excluded:
            tl.excluded = False
            tl.reset()
            self.readmissions += 1
            rec = self._rec
            if rec is not None:
                rec.append(OBS.READMIT, self._clock.now, {
                    "engine": self._owner, "link": link_id,
                    "verified": verified})
            if verified and self.on_readmit is not None:
                self.on_readmit(link_id)
            return True
        return False

    def apply_remote(self, link_id: int, *, excluded: bool) -> bool:
        """Apply another engine's opinion about a link — the single entry
        point for cluster rumors and anti-entropy merges. Deliberately the
        weakest form of both transitions: a non-explicit exclude and a
        non-verified readmit, so applying remote state can never fire the
        gossip hooks back (no echo) and never outranks this engine's own
        explicit observations. Returns True when local state changed."""
        if excluded:
            return self.exclude(link_id)
        return self.readmit(link_id)

    def excluded_links(self) -> List[int]:
        # one vectorized scan of the store's exclusion array (the monitor's
        # writes land there directly through the LinkTelemetry views)
        return self.store.excluded_link_ids()

    # -- retry path selection (reliability over latency) ----------------------
    def choose_retry(
        self, candidates: Sequence[Candidate], exclude_links: Sequence[int]
    ) -> Candidate | None:
        elig = [
            c
            for c in candidates
            if not c.telemetry.excluded and c.link_id not in exclude_links
            and not (c.remote is not None and c.remote.excluded)
            and c.tier < 99
        ]
        if not elig:
            # everything excluded: retry on the least-failed rail anyway
            # (liveness over latency); the prober will sort the rest out.
            elig = [c for c in candidates if c.link_id not in exclude_links and c.tier < 99]
        if not elig:
            return None
        best = min(elig, key=lambda c: (c.tier, c.telemetry.failures, c.link_id))
        return best
