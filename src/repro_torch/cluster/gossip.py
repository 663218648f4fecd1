"""Modeled control-plane links: lossy/delayed gossip + partial peer views.

An idealized control plane delivers telemetry and rumors over a
zero-loss broadcast — every message arrived, instantly, at every peer. Real
control planes run over the same imperfect network as the data plane: gossip
datagrams get dropped, delivery lags the send, and no engine holds an
instantaneous global membership view. The paper's sub-50 ms self-healing
claim (§4.2/§4.3) only counts if it survives that, so this module models it:

  * `GossipChannel` — every control-plane message (telemetry snapshot, rumor,
    anti-entropy digest) passes through one channel with a per-message loss
    probability and a delivery delay on the shared virtual clock. The RNG is
    seeded and private to the channel, so lossy runs are exactly reproducible
    and — critically — a zero-loss, zero-delay channel performs *no* RNG
    draws and schedules the *same* events as direct delivery, keeping
    the existing multi-engine results bit-for-bit.
  * `PeerSampler` — fanout-k partial membership views: instead of addressing
    every peer, a sender gossips to a k-sized sample of the live roster
    (resampled per send, seeded). Gaps that loss or small fanout leave behind
    are closed by anti-entropy reconciliation (see membership.py), and the
    roster itself churns as engines join and leave mid-run.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


class GossipChannel:
    """One lossy, delayed control-plane link shared by all cluster services.

    `send` either drops the message (probability `loss`), delivers it
    synchronously (total delay zero — the broadcast-compatible fast path), or
    schedules delivery `delay + extra_delay` ahead on the fabric's virtual
    clock. Messages are independent: two sends may be dropped, reordered
    only by their delays, or arrive after the state they carry went stale —
    exactly the hazards the staleness horizon and anti-entropy exist for.
    """

    def __init__(self, fabric, *, loss: float = 0.0, delay: float = 0.0, seed: int = 0):
        if not 0.0 <= loss < 1.0:
            raise ValueError(f"gossip loss must be in [0, 1), got {loss}")
        if delay < 0:
            raise ValueError(f"gossip delay must be >= 0, got {delay}")
        self.fabric = fabric
        self.loss = loss
        self.delay = delay
        # private seeded RNG: control-plane loss never perturbs data-plane
        # jitter streams, so a lossy run is as reproducible as a clean one
        self._rng = np.random.default_rng(seed)
        self.sent = 0
        self.dropped = 0
        self.delivered = 0

    def send(self, deliver: Callable[[], None], *, extra_delay: float = 0.0) -> bool:
        """Queue one message; returns False when the channel dropped it.
        Zero total delay delivers synchronously (no event, no RNG draw when
        loss is zero): the idealized broadcast control plane is the special case
        loss=0/delay=0 of this one."""
        self.sent += 1
        if self.loss > 0.0 and self._rng.random() < self.loss:
            self.dropped += 1
            return False
        total = self.delay + extra_delay
        if total <= 0.0:
            self.delivered += 1
            deliver()
        else:
            def _arrive() -> None:
                self.delivered += 1
                deliver()

            self.fabric.call_after(total, _arrive)
        return True


class PeerSampler:
    """Fanout-k partial membership views over a churning roster.

    `fanout <= 0` (the default) means full views — every send addresses every
    live peer, the idealized broadcast. A positive fanout samples that many peers
    per send from the sender's current roster (seeded RNG, insertion-ordered,
    so runs are deterministic); `anti_entropy_partner` rotates round-robin so
    reconciliation coverage is uniform without consuming randomness."""

    def __init__(self, *, fanout: int = 0, seed: int = 0):
        self.fanout = fanout
        self._rng = np.random.default_rng(seed)
        self._members: List[str] = []
        self._ae_cursor = 0

    # ------------------------------------------------------------------ roster
    def add(self, name: str) -> None:
        if name not in self._members:
            self._members.append(name)

    def remove(self, name: str) -> None:
        if name in self._members:
            self._members.remove(name)

    def members(self) -> Tuple[str, ...]:
        return tuple(self._members)

    # ------------------------------------------------------------------ views
    def peers_of(self, name: str) -> Tuple[str, ...]:
        """The full live roster minus the asker — what a zero-fanout view is."""
        return tuple(m for m in self._members if m != name)

    def view(self, name: str) -> Tuple[str, ...]:
        """The sender's current partial view: fanout-k peers sampled without
        replacement, or everyone when fanout is off / covers the roster. The
        full-view path performs no RNG draws (bit-for-bit with the idealized broadcast)."""
        others = self.peers_of(name)
        if self.fanout <= 0 or self.fanout >= len(others):
            return others
        idx = self._rng.choice(len(others), size=self.fanout, replace=False)
        return tuple(others[i] for i in sorted(idx))

    def anti_entropy_partner(self, name: str) -> Optional[str]:
        """Deterministic rotating partner for state reconciliation; None when
        the asker is the only live member."""
        others = self.peers_of(name)
        if not others:
            return None
        partner = others[self._ae_cursor % len(others)]
        self._ae_cursor += 1
        return partner
