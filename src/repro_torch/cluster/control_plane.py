"""Cluster control plane: multiple TENT engines on one shared fabric.

The paper's deployment model is one engine process per serving role —
prefill pool, decode pool, cache tier, trainer — all moving data over the
same physical interconnects. `TentCluster` materializes that: one
`Topology` + `Fabric` (one virtual clock), one `TentEngine` per
`EngineRole`, each owning a disjoint node subset, wired together by the two
cluster services that dissolve the communication silos:

  * `GlobalLoadTable` — periodic telemetry diffusion feeding every engine's
    `TelemetryStore.global_load`, so the dormant omega term of Eq. 1
    finally sees other engines' traffic (paper §4.2);
  * `ClusterMembership` — failure-rumor gossip, so one engine's exclusion
    reroutes every engine's slices before they each pay the detection
    latency themselves (paper §4.3 at cluster scope).

Both services are enabled by `ClusterParams.diffusion`; with it off the
engines still share the wire (and contend on it) but observe each other only
through their own telemetry — the siloed baseline the paper argues against.

Control-plane realism: every cross-engine message rides one `GossipChannel`
(per-message loss probability `gossip_loss`, delivery delay
`gossip_link_delay`, seeded RNG) and addresses the peers in the sender's
`PeerSampler` view (`fanout` > 0 gives partial membership views); anti-
entropy reconciliation rides the diffusion cadence and closes whatever gaps
loss, delay, small fanout, or membership churn open. At loss 0 / delay 0 /
full views the channel is a pass-through and the cluster behaves exactly
like the idealized broadcast, bit for bit.

Membership churn: `add_engine` / `remove_engine` change the cluster mid-run.
A joiner starts with an empty load table and rumor replica (no instant
global knowledge — anti-entropy fills it in); a leaver's telemetry entries
and rumor replica are garbage-collected immediately on every peer so its
final published footprint cannot linger as ghost pressure. Departed engines
keep draining their in-flight slices on the data plane and stay visible to
`audit()`/`counters()` — the zero-lost-slice invariant covers engines that
left.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..core.engine import EngineConfig, TentEngine
from ..obs import events as OBS
from ..core.fabric import Fabric, FabricConfig
from ..core.topology import FabricSpec, Topology
from .diffusion import GlobalLoadTable
from .gossip import GossipChannel, PeerSampler
from .membership import ClusterMembership


@dataclasses.dataclass(frozen=True)
class EngineRole:
    """One engine process: a name, the node subset it owns, its policy."""

    name: str
    nodes: Tuple[int, ...]
    policy: str = "tent"

    def __post_init__(self) -> None:
        if not self.nodes:
            raise ValueError(f"role {self.name!r} owns no nodes")


@dataclasses.dataclass(frozen=True)
class ClusterParams:
    """Control-plane knobs shared by all engines of one cluster."""

    diffusion: bool = True  # master switch for both cluster services
    global_weight: float = 0.6  # omega handed to every engine when on
    diffusion_period: float = 0.001  # seconds between telemetry exchanges
    diffusion_staleness: float = 0.02  # table entries older than this are dropped
    gossip_delay: float = 0.0005  # rumor propagation latency
    # control-plane link model (0/0/0 = the idealized lossless broadcast)
    gossip_loss: float = 0.0  # per-message drop probability
    gossip_link_delay: float = 0.0  # per-message delivery delay (virtual s)
    fanout: int = 0  # peers addressed per gossip send; <=0 = everyone

    def __post_init__(self) -> None:
        if self.diffusion_period > 0 and self.diffusion_staleness < self.diffusion_period:
            # delivery is one period stale by construction; a smaller
            # staleness horizon would silently drop every table entry
            raise ValueError(
                f"diffusion_staleness ({self.diffusion_staleness}) must be >= "
                f"diffusion_period ({self.diffusion_period})")
        if not 0.0 <= self.gossip_loss < 1.0:
            raise ValueError(f"gossip_loss must be in [0, 1), got {self.gossip_loss}")
        if self.gossip_link_delay < 0:
            raise ValueError(
                f"gossip_link_delay must be >= 0, got {self.gossip_link_delay}")
        if self.gossip_link_delay > 0 and self.diffusion_period > 0 and (
                self.gossip_link_delay + self.diffusion_period > self.diffusion_staleness):
            # a snapshot ages one period before it ships plus the link delay
            # in flight; past the horizon every delivery would arrive dead
            raise ValueError(
                f"gossip_link_delay ({self.gossip_link_delay}) + diffusion_period "
                f"({self.diffusion_period}) must be <= diffusion_staleness "
                f"({self.diffusion_staleness}) or every telemetry delivery arrives stale")


class TentCluster:
    """N engines, one fabric, one virtual clock, two cluster services."""

    def __init__(
        self,
        spec: FabricSpec,
        roles: Sequence[EngineRole],
        *,
        engine_config: Optional[EngineConfig] = None,
        params: Optional[ClusterParams] = None,
        seed: int = 0,
    ):
        self.params = params or ClusterParams()
        self.topology = Topology(spec)
        self._base_config = engine_config or EngineConfig()
        self.fabric = Fabric(
            self.topology, seed=seed,
            config=FabricConfig(event_queue="calendar")
            if self._base_config.calendar_queue else None)
        self.seed = seed
        self.roles = tuple(roles)
        self._validate_roles(self.roles, spec.n_nodes)
        self.engines: Dict[str, TentEngine] = {}
        self.departed: Dict[str, TentEngine] = {}
        self.joins = 0
        self.leaves = 0
        # flight recorder (repro_torch.obs); attach_recorder fans it out to the
        # fabric, every engine (joiners included), and the membership layer
        self._rec = None
        self._node_owner: Dict[int, str] = {}
        for role in self.roles:
            self.engines[role.name] = self._build_engine(role)
            for n in role.nodes:
                self._node_owner[n] = role.name
        self.channel: Optional[GossipChannel] = None
        self.sampler: Optional[PeerSampler] = None
        self.diffusion: Optional[GlobalLoadTable] = None
        self.membership: Optional[ClusterMembership] = None
        if self.params.diffusion:
            # one channel + one roster shared by both services, seeded apart
            # from the fabric so control-plane loss never perturbs data-plane
            # jitter draws
            self.channel = GossipChannel(
                self.fabric, loss=self.params.gossip_loss,
                delay=self.params.gossip_link_delay, seed=seed * 7919 + 101)
            self.sampler = PeerSampler(
                fanout=self.params.fanout, seed=seed * 7919 + 202)
            self.diffusion = GlobalLoadTable(
                self.fabric, self.engines,
                period=self.params.diffusion_period,
                staleness=self.params.diffusion_staleness,
                channel=self.channel, sampler=self.sampler,
            )
            self.membership = ClusterMembership(
                self.fabric, self.engines,
                gossip_delay=self.params.gossip_delay,
                channel=self.channel, sampler=self.sampler,
            )
            # anti-entropy reconciliation rides the telemetry cadence
            self.diffusion.on_round = self.membership.run_anti_entropy

    def attach_recorder(self, rec) -> None:
        """Attach one shared flight recorder to every layer of
        the cluster: fabric fault events, each engine's scheduling and
        health events, and the membership gossip. Engines joining later are
        attached automatically in `add_engine`."""
        self._rec = rec
        self.fabric.attach_recorder(rec)
        for engine in self._all_engines().values():
            engine.attach_recorder(rec)
        if self.membership is not None:
            self.membership.attach_recorder(rec)

    def register_metrics(self, reg) -> None:
        """Expose the cluster's control-plane and scheduling counters on a
        `repro_torch.obs.MetricsRegistry` as one lazy gauge group (a single
        `counters()` snapshot per collection)."""
        def _collect() -> Dict[str, float]:
            c = self.counters()
            out = {"engines": float(len(self.engines))}
            for key in ("diffusion_rounds", "rumors_sent", "rumors_applied",
                        "gossip_msgs", "gossip_dropped",
                        "anti_entropy_repairs", "engines_joined",
                        "engines_left", "slices_issued", "waves",
                        "completions_drained", "completion_batches"):
                out[key] = float(c[key])
            return out
        reg.gauge_group(_collect)

    def _build_engine(self, role: EngineRole) -> TentEngine:
        omega = self.params.global_weight if self.params.diffusion else 0.0
        cfg = dataclasses.replace(
            self._base_config, policy=role.policy, global_diffusion_weight=omega)
        return TentEngine(
            topology=self.topology, fabric=self.fabric,
            config=cfg, seed=self.seed, name=role.name,
        )

    @staticmethod
    def _validate_roles(roles: Sequence[EngineRole], n_nodes: int) -> None:
        names = [r.name for r in roles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate role names in {names}")
        owned: Dict[int, str] = {}
        for r in roles:
            for n in r.nodes:
                if not 0 <= n < n_nodes:
                    raise ValueError(
                        f"role {r.name!r} claims node {n} outside the "
                        f"{n_nodes}-node fabric")
                if n in owned:
                    raise ValueError(
                        f"node {n} owned by both {owned[n]!r} and {r.name!r}")
                owned[n] = r.name

    # ------------------------------------------------------------------ churn
    def add_engine(
        self, name: str, nodes: Tuple[int, ...], *, policy: str = "tent"
    ) -> TentEngine:
        """An engine joins the running cluster, owning `nodes` (which must be
        free — never owned, or released by a departed engine). It starts
        cold: empty telemetry table, empty rumor replica, no knowledge of
        open exclusions — the control plane's anti-entropy and the next
        diffusion rounds bring it up to speed, exactly like a process joining
        a real deployment."""
        if name in self.engines or name in self.departed:
            raise ValueError(f"engine name {name!r} already used in this cluster")
        role = EngineRole(name, tuple(nodes), policy)
        for n in role.nodes:
            if not 0 <= n < self.topology.spec.n_nodes:
                raise ValueError(
                    f"role {name!r} claims node {n} outside the "
                    f"{self.topology.spec.n_nodes}-node fabric")
            if n in self._node_owner:
                raise ValueError(
                    f"node {n} owned by both {self._node_owner[n]!r} and {name!r}")
        engine = self._build_engine(role)
        self.engines[name] = engine
        self.roles = self.roles + (role,)
        for n in role.nodes:
            self._node_owner[n] = name
        if self.diffusion is not None:
            self.diffusion.attach(name)
            # the timer may have quiesced while the cluster was idle before
            # this join; re-arm so the joiner actually gets diffusion rounds
            # and anti-entropy (arm is idempotent, and the next tick disarms
            # again if nobody has open work)
            self.diffusion.arm()
        if self.membership is not None:
            self.membership.join(name, engine)
        self.joins += 1
        if self._rec is not None:
            engine.attach_recorder(self._rec)
            self._rec.append(OBS.ENGINE_JOIN, self.fabric.now, {
                "engine": name, "nodes": list(role.nodes)})
        return engine

    def remove_engine(self, name: str) -> TentEngine:
        """An engine leaves the running cluster: its telemetry entries are
        garbage-collected from every peer's table immediately (no ghost
        pressure until the staleness horizon), its rumor replica and health
        hooks are dropped, and its nodes are released. The engine object
        itself keeps draining any in-flight slices on the shared fabric and
        remains part of `audit()` — leaving is a control-plane event, not an
        amnesty for lost slices."""
        engine = self.engines.pop(name, None)
        if engine is None:
            raise KeyError(f"no active engine {name!r} to remove")
        self.departed[name] = engine
        self.roles = tuple(r for r in self.roles if r.name != name)
        for n in [n for n, owner in self._node_owner.items() if owner == name]:
            del self._node_owner[n]
        if self.diffusion is not None:
            self.diffusion.forget(name)
        if self.membership is not None:
            self.membership.leave(name, engine)
        # the leaver forgets the cluster too: its diffused view is void
        engine.store.clear_global()
        self.leaves += 1
        if self._rec is not None:
            self._rec.append(OBS.ENGINE_LEAVE, self.fabric.now,
                             {"engine": name})
        return engine

    # ------------------------------------------------------------------ access
    def engine(self, name: str) -> TentEngine:
        return self.engines[name]

    def engine_for_node(self, node: int) -> TentEngine:
        return self.engines[self._node_owner[node]]

    @property
    def now(self) -> float:
        return self.fabric.now

    @property
    def busy(self) -> bool:
        return any(e.open_batches > 0 for e in self.engines.values())

    def _all_engines(self) -> Dict[str, TentEngine]:
        out = dict(self.engines)
        out.update(self.departed)
        return out

    # ------------------------------------------------------------------ drive
    def start(self) -> None:
        """Arm the diffusion timer. Call after the first submissions; the
        timer keeps itself armed while any engine has open work."""
        if self.diffusion is not None:
            self.diffusion.arm()

    def step(self) -> bool:
        return self.fabric.step()

    def run_until_idle(self) -> None:
        self.fabric.run_until_idle()

    # ------------------------------------------------------------------ audit
    def audit(
        self, *, ignore: Optional[Dict[str, Iterable[int]]] = None
    ) -> Dict[str, Dict[str, int]]:
        """Per-engine slice accounting plus a merged `total` entry. The
        zero-lost-slice invariant must hold on *every* engine of the
        cluster — including engines that departed mid-run, whose in-flight
        batches still drain on the shared fabric."""
        ignore = ignore or {}
        out: Dict[str, Dict[str, int]] = {}
        total = {"batches_done": 0, "batches_failed": 0, "batches_open": 0,
                 "slices_outstanding": 0}
        for name, e in self._all_engines().items():
            a = e.audit(ignore=tuple(ignore.get(name, ())))
            out[name] = a
            for k in total:
                total[k] += a[k]
        out["total"] = total
        return out

    # ------------------------------------------------------------------ stats
    def counters(self) -> Dict[str, int]:
        """Cluster-wide resilience/scheduling counters, summed over all
        engines that ever served (active + departed), plus the control
        plane's gossip accounting."""
        engines = self._all_engines().values()
        out = {
            "retries": sum(e.slices_retried for e in engines),
            "exclusions": sum(e.health.exclusions for e in engines),
            "readmissions": sum(e.health.readmissions for e in engines),
            "substitutions": sum(e.backend_substitutions for e in engines),
            "slices_issued": sum(e.slices_issued for e in engines),
            "waves": sum(e.waves for e in engines),
            "completions_drained": sum(e.completions_drained for e in engines),
            "completion_batches": sum(e.completion_batches for e in engines),
            "diffusion_rounds": self.diffusion.rounds if self.diffusion else 0,
            "rumors_sent": self.membership.rumors_sent if self.membership else 0,
            "rumors_applied": self.membership.rumors_applied if self.membership else 0,
            "gossip_msgs": self.channel.sent if self.channel else 0,
            "gossip_dropped": self.channel.dropped if self.channel else 0,
            "anti_entropy_repairs": (
                self.membership.anti_entropy_repairs if self.membership else 0),
            "engines_joined": self.joins,
            "engines_left": self.leaves,
        }
        return out
