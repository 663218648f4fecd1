"""Cluster membership and failure-rumor propagation over a lossy channel.

One engine's data-plane observation — an explicit wire failure or an
implicitly detected straggler — soft-excludes the suspect link(s) locally
(paper §4.3). On a multi-engine fabric that observation is worth much more:
every peer that would route a slice over the same endpoint is about to pay
`FAIL_DETECT_LATENCY` plus retries to rediscover it. `ClusterMembership`
subscribes to each engine's `HealthMonitor` exclusion/readmission hooks and
gossips the event to the peers in the origin's current membership view, so
the cluster reroutes off a dying link within one rumor hop of the first
observation — and re-integrates it the moment the observing engine's prober
readmits it.

Unlike a zero-loss broadcast, rumors now travel as individual
`GossipChannel` messages that can be dropped or delayed, and with fanout-k
partial views a rumor doesn't even *address* every peer. Three mechanisms
keep the cluster consistent anyway:

  * versioned rumor records — every exclude/readmit event carries a
    monotonically increasing version; each engine holds a replica map
    (link -> latest record) and applies a record only when it is newer than
    what the replica holds, so reordered or duplicate deliveries are inert;
  * anti-entropy reconciliation — piggybacked on the diffusion cadence, each
    engine pushes its full replica to one rotating partner per round; a peer
    that missed a rumor (loss, partial view, or having joined after the
    fact) converges within a few rounds;
  * churn GC — `leave()` drops the departed engine's replica, unhooks its
    health callbacks and removes it from the roster, so no rumor state
    accumulates for engines that no longer exist (rumors it *originated*
    remain valid facts about links and stay in the survivors' replicas).

Rumor application cannot echo by construction: rumors are applied through
`HealthMonitor.apply_remote` (non-explicit exclude / non-verified readmit),
and the health hooks fire only for explicit failures / probe-verified
readmissions.

Lifecycle: an exclusion rumor for a link suppresses repeats for
`rumor_refresh` seconds (one outage, one rumor), then later explicit
observations re-gossip — so a rumor that never got closed (the origin's
prober stopped, or a blind reset readmitted locally without gossip) cannot
permanently silence future failure news for that link. Any engine's
probe-verified readmission closes the rumor cluster-wide. A peer whose
periodic blind reset readmitted a rumored link locally diverges from the
replica *state* only, never the replica *record* — anti-entropy will not
re-impose the exclusion (same version, no new information), exactly the
idealized broadcast's semantics.
"""
from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from ..obs import events as OBS
from .gossip import GossipChannel, PeerSampler

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (typing only)
    from ..core.engine import TentEngine
    from ..core.fabric import Fabric

# one rumor record: (version, excluded?) for a link
Record = Tuple[int, bool]


class ClusterMembership:
    """Churning membership + versioned exclusion/readmission gossip."""

    def __init__(
        self,
        fabric: "Fabric",
        engines: Dict[str, "TentEngine"],
        *,
        gossip_delay: float = 0.0005,
        rumor_refresh: float = 0.05,
        channel: Optional[GossipChannel] = None,
        sampler: Optional[PeerSampler] = None,
    ):
        self.fabric = fabric
        self.engines = engines  # live view: TentCluster mutates it on churn
        self.gossip_delay = gossip_delay
        self.rumor_refresh = rumor_refresh
        self.channel = channel or GossipChannel(fabric)
        self.sampler = sampler or PeerSampler()
        self.rumors_sent = 0
        self.rumors_applied = 0
        self.anti_entropy_repairs = 0
        self.joins = 0
        self.leaves = 0
        # flight recorder (repro_torch.obs); None = tracing off
        self._rec = None
        # Open rumors: link -> virtual time the exclusion rumor went out.
        # Closed by any probe-verified readmission (blind periodic resets
        # never gossip), and refreshable after `rumor_refresh` so a rumor
        # nobody managed to close cannot suppress future failure news.
        self._rumored: Dict[int, float] = {}
        # Per-engine rumor replicas: name -> {link_id: (version, excluded)}.
        # The version clock is global to the (simulated) cluster; records
        # only ever move forward, so replicas converge under any delivery
        # order anti-entropy and the lossy channel produce.
        self._vclock = itertools.count(1)
        self._state: Dict[str, Dict[int, Record]] = {}
        for name, e in engines.items():
            self._enroll(name, e)

    def attach_recorder(self, rec) -> None:
        self._rec = rec

    def members(self) -> List[str]:
        return sorted(self._state)

    # ------------------------------------------------------------------ churn
    def _enroll(self, name: str, engine: "TentEngine") -> None:
        self._state[name] = {}
        self.sampler.add(name)
        engine.health.on_exclude = self._hook(name, exclude=True)
        engine.health.on_readmit = self._hook(name, exclude=False)

    def join(self, name: str, engine: "TentEngine") -> None:
        """A new engine joined mid-run. It starts with an empty replica and
        no knowledge of open rumors — anti-entropy pushes from established
        members bring it up to date over the next rounds (partial membership
        by construction: there is no instant-bootstrap side channel)."""
        self._enroll(name, engine)
        self.joins += 1

    def leave(self, name: str, engine: "TentEngine") -> None:
        """An engine departed: unhook its health callbacks, GC its replica,
        drop it from the roster. In-flight messages addressed to it are
        dropped on delivery (`_receive` checks the roster)."""
        engine.health.on_exclude = None
        engine.health.on_readmit = None
        self.sampler.remove(name)
        self._state.pop(name, None)
        self.leaves += 1

    # ------------------------------------------------------------------ gossip
    def _hook(self, origin: str, *, exclude: bool):
        def fire(link_id: int) -> None:
            if exclude:
                last = self._rumored.get(link_id)
                if last is not None and self.fabric.now - last < self.rumor_refresh:
                    return  # this outage is already rumored cluster-wide
                self._rumored[link_id] = self.fabric.now
            elif link_id not in self._rumored:
                return  # local-only readmission of a never-rumored link
            else:
                del self._rumored[link_id]
            self.rumors_sent += 1
            version = next(self._vclock)
            replica = self._state.get(origin)
            if replica is not None:
                replica[link_id] = (version, exclude)
            # view() may sample (fanout-k partial views use seeded RNG), so
            # it must be called exactly once per rumor — the recorder reads
            # the same materialized list the send loop walks
            peers = list(self.sampler.view(origin))
            for peer in peers:
                self.channel.send(
                    lambda peer=peer: self._receive(peer, link_id, version, exclude),
                    extra_delay=self.gossip_delay,
                )
            rec = self._rec
            if rec is not None:
                rec.append(OBS.RUMOR_SENT, self.fabric.now, {
                    "engine": origin, "link": link_id, "version": version,
                    "exclude": exclude, "peers": len(peers)})

        return fire

    def _receive(self, peer: str, link_id: int, version: int, exclude: bool) -> bool:
        """One rumor record arrived at `peer` (directly or inside an
        anti-entropy digest). Version gating makes duplicates and reordered
        deliveries inert; only genuinely new records touch the peer's health
        (non-explicit / non-verified, so application never echoes)."""
        replica = self._state.get(peer)
        if replica is None:
            return False  # peer departed while the message was in flight
        cur = replica.get(link_id)
        if cur is not None and cur[0] >= version:
            return False  # stale or duplicate: the replica already knows more
        replica[link_id] = (version, exclude)
        engine = self.engines.get(peer)
        if engine is not None and engine.health.apply_remote(link_id, excluded=exclude):
            self.rumors_applied += 1
            rec = self._rec
            if rec is not None:
                rec.append(OBS.RUMOR_RECV, self.fabric.now, {
                    "engine": peer, "link": link_id, "version": version,
                    "exclude": exclude})
        return True

    # ------------------------------------------------------------- anti-entropy
    def run_anti_entropy(self) -> None:
        """One reconciliation round (piggybacked on the diffusion cadence):
        every member pushes its full replica to one rotating partner as a
        single channel message. Records the partner already holds are inert,
        so with a clean channel and full views this is a no-op; under loss,
        delay, partial views, or after a join it is what closes the gaps.
        Digests ride with the same `gossip_delay` as direct rumors, so a
        digest can never outrun the rumor it repairs."""
        rec = self._rec
        if rec is not None:
            rec.append(OBS.ANTI_ENTROPY, self.fabric.now,
                       {"members": len(self._state)})
        for name in list(self._state):
            replica = self._state.get(name)
            if not replica:
                continue  # nothing to reconcile from this member
            partner = self.sampler.anti_entropy_partner(name)
            if partner is None:
                continue
            digest = dict(replica)  # snapshot: in-flight mutation safe
            self.channel.send(
                lambda partner=partner, digest=digest: self._merge(partner, digest),
                extra_delay=self.gossip_delay,
            )

    def _merge(self, peer: str, digest: Dict[int, Record]) -> None:
        for link_id, (version, exclude) in digest.items():
            if self._receive(peer, link_id, version, exclude):
                self.anti_entropy_repairs += 1
