"""Phase 1: Dynamic Orchestration (paper §4.1).

The orchestrator resolves a declarative transfer into a *transport plan*: a
ranked list of route options (direct backends or synthesized staged routes),
each annotated with tier info. Binding is late — the plan retains multiple
candidates so later phases can steer slices away from congested/failed rails
and substitute whole backends without application involvement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .scheduler import Candidate
from .segments import Segment
from .transports import TransportBackend, WirePath
from .types import Location, MemoryKind, TentError, UNREACHABLE


@dataclasses.dataclass(frozen=True)
class Stage:
    """One hop of a (possibly multi-hop) route."""

    backend: str
    src: Location
    dst: Location


@dataclasses.dataclass
class RouteOption:
    """A complete way to realize the transfer: one or more stages, ranked by
    nominal aggregate bandwidth of its bottleneck stage."""

    stages: List[Stage]
    rank_bandwidth: float

    @property
    def direct(self) -> bool:
        return len(self.stages) == 1

    @property
    def backend_names(self) -> List[str]:
        return [s.backend for s in self.stages]


@dataclasses.dataclass
class TransportPlan:
    src: Location
    dst: Location
    options: List[RouteOption]  # ranked best-first
    route_idx: int = 0  # advanced by backend substitution (paper §4.3)

    @property
    def current(self) -> RouteOption:
        return self.options[self.route_idx]

    def substitute(self) -> bool:
        """Promote the next-best transport. Returns False when exhausted."""
        if self.route_idx + 1 < len(self.options):
            self.route_idx += 1
            return True
        return False


@dataclasses.dataclass
class StageCandidates:
    """The cached, array-annotated candidate set for one plan stage.

    A `Stage` is a pure (backend, src, dst) value, so its wire paths — and
    therefore its schedulable candidate set — are a static function of the
    topology. The engine builds this once per distinct stage and reuses it
    for every slice, instead of re-enumerating paths and re-allocating
    `Candidate` objects per slice as the pre-wave hot path did. Alongside
    the object lists (still consumed by the scalar policies and the retry
    chooser) it carries:

      * `path_by_link` — the link-id → WirePath index (O(1) lookup where
        `TentEngine._issue` used to linearly scan the path list);
      * per-candidate numpy arrays (store slots, bandwidth, tier penalty,
        remoteness masks) — everything `TentPolicy.choose_wave` needs to
        gather a wave's telemetry straight out of the store's
        struct-of-arrays state. The `local_slot`/`bandwidth` columns also
        seed each posted slice's `_InflightSlice` (slot + Eq. 1 prediction),
        which is what lets the batched completion drain gather a whole
        run's telemetry without ever re-resolving links;
      * `extra_latency` — the per-path submission latency with the engine's
        amortized posting overhead folded in, precomputed so the wave post
        loop does no arithmetic per slice.
    """

    stage: Stage
    paths: List[WirePath]
    cands: List[Candidate]
    path_by_link: Dict[int, WirePath]
    local_slot: np.ndarray  # store slots of the local (schedulable) links
    remote_slot_safe: np.ndarray  # remote store slots, 0 where pathless
    has_remote: np.ndarray  # bool mask: which candidates pair a remote NIC
    remote_any: bool
    local_links: Tuple[int, ...]
    remote_links: Tuple[Optional[int], ...]
    bandwidth: np.ndarray
    penalty: Optional[np.ndarray]  # tier penalties (None for non-TENT policies)
    extra_latency: Tuple[float, ...]
    zeros: np.ndarray


def build_stage_candidates(
    stage: Stage,
    backends: Dict[str, TransportBackend],
    store,
    *,
    tier_penalty: Optional[Dict[int, float]] = None,
    post_overhead: float = 0.0,
) -> StageCandidates:
    """Materialize one stage's candidate set with its scheduling arrays."""
    be = backends[stage.backend]
    paths = be.paths(stage.src, stage.dst)
    cands = [
        Candidate(
            store.ensure(p.local), p.tier,
            remote=store.ensure(p.remote) if p.remote is not None else None,
        )
        for p in paths
    ]
    n = len(paths)
    remote_slots = np.fromiter(
        (c.remote.slot if c.remote is not None else -1 for c in cands),
        dtype=np.int64, count=n)
    inf = float("inf")
    return StageCandidates(
        stage=stage,
        paths=paths,
        cands=cands,
        path_by_link={p.local.link_id: p for p in paths},
        local_slot=np.fromiter((c.telemetry.slot for c in cands),
                               dtype=np.int64, count=n),
        remote_slot_safe=np.maximum(remote_slots, 0),
        has_remote=remote_slots >= 0,
        remote_any=bool((remote_slots >= 0).any()),
        local_links=tuple(p.local.link_id for p in paths),
        remote_links=tuple(
            p.remote.link_id if p.remote is not None else None for p in paths),
        bandwidth=np.fromiter((p.local.bandwidth for p in paths),
                              dtype=np.float64, count=n),
        penalty=(np.fromiter((tier_penalty.get(p.tier, inf) for p in paths),
                             dtype=np.float64, count=n)
                 if tier_penalty is not None else None),
        extra_latency=tuple(p.extra_latency + post_overhead for p in paths),
        zeros=np.zeros(n, dtype=np.float64),
    )


def _staging_host(loc: Location) -> Location:
    """The internal host staging buffer location for a device/file endpoint."""
    if loc.kind == MemoryKind.DEVICE_HBM:
        return Location(node=loc.node, kind=MemoryKind.HOST_DRAM, device=0, numa=loc.numa)
    if loc.kind == MemoryKind.FILE:
        return Location(node=loc.node, kind=MemoryKind.HOST_DRAM, device=0, numa=0)
    return loc


class Orchestrator:
    """Enumerates feasible paths through the heterogeneous fabric and emits
    ranked transport plans. Pure control plane: no bytes move here."""

    def __init__(self, backends: Dict[str, TransportBackend]):
        self.backends = backends

    # -- public -------------------------------------------------------------
    def resolve(self, src_seg: Segment, dst_seg: Segment) -> TransportPlan:
        src, dst = src_seg.location, dst_seg.location
        options = self._direct_options(src, dst) + self._staged_options(src, dst)
        if not options:
            raise TentError(UNREACHABLE, f"no route {src} -> {dst}")
        options.sort(key=lambda o: (-o.rank_bandwidth, len(o.stages)))
        return TransportPlan(src=src, dst=dst, options=options)

    # -- direct -------------------------------------------------------------
    def _direct_options(self, src: Location, dst: Location) -> List[RouteOption]:
        out: List[RouteOption] = []
        for be in self.backends.values():
            if be.feasible(src, dst):
                bw = be.rank_bandwidth(src, dst)
                if bw > 0:
                    out.append(RouteOption([Stage(be.name, src, dst)], bw))
        return out

    # -- staged synthesis (paper §4.1: D2H -> H2H -> H2D pipelined) ----------
    def _staged_options(self, src: Location, dst: Location) -> List[RouteOption]:
        if src.node == dst.node and src.kind == dst.kind == MemoryKind.HOST_DRAM:
            return []
        hops: List[Stage] = []
        cur = src
        if src.kind != MemoryKind.HOST_DRAM:
            stage = _staging_host(src)
            be = self._hop_backend(cur, stage)
            if be is None:
                return []
            hops.append(Stage(be, cur, stage))
            cur = stage
        if cur.node != dst.node:
            remote_host = _staging_host(dst) if dst.kind != MemoryKind.HOST_DRAM else dst
            be = self._hop_backend(cur, remote_host)
            if be is None:
                return []
            hops.append(Stage(be, cur, remote_host))
            cur = remote_host
        if cur != dst:
            be = self._hop_backend(cur, dst)
            if be is None:
                return []
            hops.append(Stage(be, cur, dst))
        if len(hops) <= 1:
            return []
        # Bottleneck stage bandwidth ranks the whole staged route; staged
        # routes are always out-ranked by a feasible direct fast fabric.
        bw = min(self._hop_bw(s) for s in hops) * 0.9
        return [RouteOption(hops, bw)]

    def _hop_backend(self, src: Location, dst: Location) -> str | None:
        best, best_bw = None, 0.0
        for be in self.backends.values():
            if be.feasible(src, dst):
                bw = be.rank_bandwidth(src, dst)
                if bw > best_bw:
                    best, best_bw = be.name, bw
        return best

    def _hop_bw(self, stage: Stage) -> float:
        return self.backends[stage.backend].rank_bandwidth(stage.src, stage.dst)
