"""Global load diffusion service (paper §4.2) over a modeled gossip channel.

In the paper every TENT engine process periodically publishes its per-NIC
queue depths and blends a global load factor into Eq. 1 with weight omega.
This module is that exchange for the simulated cluster — but unlike an idealized
shared-memory table, delivery is now *messaging*: each diffusion round every
engine's snapshot (local queues plus remote-endpoint charges,
`TelemetryStore.snapshot`) is sent to the peers in its current membership
view as individual `GossipChannel` messages, each of which can be dropped or
delayed. Every engine keeps its own receive table (sender -> timestamped
snapshot); each round it re-derives `store.global_load` from the entries
that are still inside the staleness horizon, so a dropped or late round
degrades the view gracefully instead of corrupting it. Delivery remains one
round stale by construction — a round first ships the previous round's
snapshots, then captures fresh ones — and with a zero-loss/zero-delay
channel and full views this reduces exactly to that table.

Both ends of the exchange lean on the array-backed telemetry store: the
per-round `snapshot()` capture is one vectorized scan of the queue array
(not a per-link Python loop), and the `apply_global` delivery installs the
aggregated view as the sparse dict the omega blend reads once per wave —
see `repro_torch.core.telemetry` for the array/dict split rationale.

The timer rides the shared fabric's virtual clock and disarms itself when no
engine has open work, so idle clusters quiesce and `run_until_idle` halts.
Engines can join (`attach`) and leave (`forget`) mid-run: a departed
engine's table entries are garbage-collected immediately on every peer, so
its final published footprint cannot linger as ghost pressure.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

from .gossip import GossipChannel, PeerSampler

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (typing only)
    from ..core.engine import TentEngine
    from ..core.fabric import Fabric


class GlobalLoadTable:
    """Periodic cross-engine telemetry exchange over the gossip channel."""

    def __init__(
        self,
        fabric: "Fabric",
        engines: Dict[str, "TentEngine"],
        *,
        period: float = 0.001,
        staleness: float = 0.02,
        channel: Optional[GossipChannel] = None,
        sampler: Optional[PeerSampler] = None,
    ):
        self.fabric = fabric
        self.engines = engines  # live view: TentCluster mutates it on churn
        self.period = period
        self.staleness = staleness
        self.channel = channel or GossipChannel(fabric)
        self.sampler = sampler or PeerSampler()
        for name in engines:
            self.sampler.add(name)
        self.rounds = 0
        self._armed = False
        # a hook the cluster uses to piggyback anti-entropy on the cadence
        self.on_round: Optional[Callable[[], None]] = None
        # engine name -> (publish time, {link_id: queued bytes}) captured at
        # the END of the previous round — what this round ships (one-round
        # staleness by construction)
        self._outbox: Dict[str, Tuple[float, Dict[int, int]]] = {}
        # receiver name -> sender name -> (publish time, snapshot): each
        # engine's own partial, possibly stale view of the cluster's load
        self._tables: Dict[str, Dict[str, Tuple[float, Dict[int, int]]]] = {
            name: {} for name in engines
        }

    # ------------------------------------------------------------------ timer
    def arm(self) -> None:
        """Start (or keep) the diffusion timer. Idempotent; call after
        submitting work. The timer re-arms itself while any engine is busy."""
        if self._armed or self.period <= 0:
            return
        self._armed = True
        self.fabric.call_after(self.period, self._tick)

    def _tick(self) -> None:
        self._armed = False
        self.diffuse()  # ship LAST round's snapshots: one-period staleness
        self.publish()
        self.rounds += 1
        if self.on_round is not None:
            self.on_round()
        if any(e.open_batches > 0 for e in self.engines.values()):
            self.arm()

    # ------------------------------------------------------------------ churn
    def attach(self, name: str) -> None:
        """An engine joined: give it an empty receive table and a roster slot.
        Its view of the cluster fills in over the next rounds — partial
        knowledge by construction, no instant global bootstrap."""
        self._tables.setdefault(name, {})
        self.sampler.add(name)

    def forget(self, name: str) -> None:
        """An engine left: GC its outbox, roster slot, receive table, and —
        the part peers would otherwise only fix at the staleness horizon —
        its entries in every other engine's table, then re-derive each
        peer's global load so no ghost pressure survives the departure."""
        self.sampler.remove(name)
        self._outbox.pop(name, None)
        self._tables.pop(name, None)
        for table in self._tables.values():
            table.pop(name, None)
        for peer in self._tables:
            eng = self.engines.get(peer)
            if eng is not None:
                eng.store.apply_global(self._aggregate(peer))

    # ------------------------------------------------------------------ table
    def publish(self) -> None:
        """Every live engine captures its current footprint into the outbox
        (shipped next round)."""
        now = self.fabric.now
        for name, e in self.engines.items():
            self._outbox[name] = (now, e.store.snapshot())

    def diffuse(self) -> None:
        """Ship the outbox: one channel message per (sender, view-peer) pair,
        then re-derive every engine's global load from whatever its table
        holds. With loss or delay on the channel some tables now miss this
        round — their engines keep scheduling on the freshest entries they
        do have, inside the staleness horizon."""
        for sender, (t, snap) in self._outbox.items():
            if sender not in self._tables:
                continue  # departed between publish and diffuse
            for peer in self.sampler.view(sender):
                self.channel.send(
                    lambda peer=peer, sender=sender, t=t, snap=snap:
                        self._receive(peer, sender, t, snap))
        now = self.fabric.now
        for name, e in self.engines.items():
            e.store.apply_global(self._aggregate(name, prune_before=now - self.staleness))

    def _receive(self, receiver: str, sender: str, t: float, snap: Dict[int, int]) -> None:
        """One snapshot message arrived (possibly late, possibly after the
        sender or receiver departed). Late entries still land in the table —
        the staleness horizon decides at read time whether they count."""
        table = self._tables.get(receiver)
        if table is None or sender not in self._tables:
            return  # receiver or sender no longer a member: drop on the floor
        prev = table.get(sender)
        if prev is not None and prev[0] > t:
            return  # a fresher snapshot already arrived (reordered delivery)
        table[sender] = (t, snap)

    def _aggregate(
        self, name: str, *, prune_before: Optional[float] = None
    ) -> Dict[int, int]:
        """Sum of *other* engines' in-horizon footprints from `name`'s own
        receive table; entries past the horizon are dropped (and pruned, so
        tables stay bounded under long runs)."""
        now = self.fabric.now
        table = self._tables.get(name, {})
        if prune_before is not None:
            for sender in [s for s, (t, _) in table.items() if t < prune_before]:
                del table[sender]
        agg: Dict[int, int] = {}
        for sender, (t, snap) in table.items():
            if sender == name or (now - t) > self.staleness:
                continue
            for lid, q in snap.items():
                agg[lid] = agg.get(lid, 0) + q
        return agg
