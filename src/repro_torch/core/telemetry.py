"""Per-link telemetry and the predictive completion-time model (paper Eq. 1).

    t_hat_d = beta0_d + beta1_d * (A_d + L) / B_d

`B_d` is the *nominal* link bandwidth from topology discovery; `A_d` is the
effective queue length in bytes (maintained by Algorithm 1 line 11); the
coefficients beta are dynamic correction factors absorbing incast, switch
congestion and silent degradation, updated by an EWMA filter from the
prediction error on every slice completion. A periodic state reset prevents
starvation of temporarily slow rails (paper §4.2 "Feedback").

Storage layout: the store is struct-of-arrays. Every per-link quantity
(beta0/beta1/queued/excluded/health counters) lives in one contiguous numpy
array, indexed by a stable slot assigned at registration time (the
link-index map). `LinkTelemetry` is a thin *view* — an object carrying
(store, slot, desc) whose attributes read and write the arrays — so the
whole pre-existing per-link API keeps working, `HealthMonitor` exclusions
land directly in the arrays, and the wave scheduler
(`TentPolicy.choose_wave` / `tent_choose_wave`) can gather a candidate
set's entire state with a handful of fancy-indexing operations instead of
touching N Python objects per slice.

The cross-engine structures (`global_load`, `remote_queued`, `_published`)
deliberately stay dicts: they are written by *other* components (the
cluster's diffusion service replaces `global_load` wholesale each round;
shared-table mode aliases one dict across several stores), they are sparse,
and they are read once per wave, not once per slice — see the core README
for the vectorized/scalar split rationale.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .topology import LinkDesc
from ..analysis import hot_path

DEFAULT_BETA0 = 0.0
DEFAULT_BETA1 = 1.0
DEFAULT_EWMA_ALPHA = 0.25
DEFAULT_BETA0_ALPHA = 0.05


def _field(name: str, arr: str):
    """Property reading/writing one SoA array slot (the view mechanics)."""

    def get(self):
        return getattr(self.store, arr)[self.slot]

    def set(self, value):
        getattr(self.store, arr)[self.slot] = value

    get.__name__ = set.__name__ = name
    return property(get, set)


class LinkTelemetry:
    """View over one link's slot in a `TelemetryStore`'s arrays.

    Constructing one directly (without `_store`) allocates a private
    single-slot store, so standalone uses (unit tests, ad-hoc scoring) keep
    the old value-object ergonomics; `TelemetryStore.ensure` hands out views
    into the shared arrays."""

    __slots__ = ("desc", "store", "slot")

    def __init__(
        self,
        desc: LinkDesc,
        beta0: float = DEFAULT_BETA0,
        beta0_prior: float = DEFAULT_BETA0,
        beta1: float = DEFAULT_BETA1,
        queued_bytes: int = 0,
        ewma_alpha: float = DEFAULT_EWMA_ALPHA,
        beta0_alpha: float = DEFAULT_BETA0_ALPHA,
        consecutive_slow: int = 0,
        excluded: bool = False,
        completions: int = 0,
        failures: int = 0,
        ewma_service_time: float = 0.0,
        *,
        _store: Optional["TelemetryStore"] = None,
    ):
        self.desc = desc
        self.store = _store if _store is not None else TelemetryStore()
        self.slot = self.store._alloc(
            self, desc,
            beta0=beta0, beta0_prior=beta0_prior, beta1=beta1,
            queued_bytes=queued_bytes, ewma_alpha=ewma_alpha,
            beta0_alpha=beta0_alpha, consecutive_slow=consecutive_slow,
            excluded=excluded, completions=completions, failures=failures,
            ewma_service_time=ewma_service_time,
        )

    beta0 = _field("beta0", "beta0_arr")
    beta0_prior = _field("beta0_prior", "beta0_prior_arr")
    beta1 = _field("beta1", "beta1_arr")
    queued_bytes = _field("queued_bytes", "queued_arr")
    ewma_alpha = _field("ewma_alpha", "ewma_alpha_arr")
    beta0_alpha = _field("beta0_alpha", "beta0_alpha_arr")
    consecutive_slow = _field("consecutive_slow", "slow_arr")
    completions = _field("completions", "completions_arr")
    failures = _field("failures", "failures_arr")
    ewma_service_time = _field("ewma_service_time", "ewma_service_arr")

    @property
    def excluded(self) -> bool:
        return bool(self.store.excluded_arr[self.slot])

    @excluded.setter
    def excluded(self, value: bool) -> None:
        self.store.excluded_arr[self.slot] = bool(value)

    def __repr__(self) -> str:  # pragma: no cover - debugging convenience
        return (f"LinkTelemetry({self.desc.name}, beta0={float(self.beta0):.3g}, "
                f"beta1={float(self.beta1):.3g}, queued={int(self.queued_bytes)}, "
                f"excluded={self.excluded})")

    def predict(self, length: int) -> float:
        """Estimated completion time for a new slice of `length` bytes."""
        return self.beta0 + self.beta1 * (self.queued_bytes + length) / self.desc.bandwidth

    def on_schedule(self, length: int) -> None:
        self.store.queued_arr[self.slot] += length

    def on_cancel(self, length: int) -> None:
        s = self.store
        s.queued_arr[self.slot] = max(0, s.queued_arr[self.slot] - length)

    def on_complete(self, length: int, queued_at_schedule: int, t_obs: float) -> None:
        """EWMA update from the observed slice completion time.

        The normalized load x = (A_sched + L) / B is what Eq. 1 multiplied by
        beta1, so the per-sample estimate of beta1 is (t_obs - beta0)/x.
        beta0 absorbs the residual fixed cost with a slower filter.
        """
        s, i = self.store, self.slot
        s.queued_arr[i] = max(0, s.queued_arr[i] - length)
        s.completions_arr[i] += 1
        alpha = s.ewma_alpha_arr[i]
        x = (queued_at_schedule + length) / self.desc.bandwidth
        if x > 0:
            sample = (t_obs - s.beta0_arr[i]) / x
            sample = min(max(sample, 0.05), 1e4)
            s.beta1_arr[i] = (1 - alpha) * s.beta1_arr[i] + alpha * sample
        resid = max(0.0, t_obs - s.beta1_arr[i] * x)
        b0a = s.beta0_alpha_arr[i]
        s.beta0_arr[i] = (1 - b0a) * s.beta0_arr[i] + b0a * resid
        s.ewma_service_arr[i] = (1 - alpha) * s.ewma_service_arr[i] + alpha * t_obs

    def on_failure(self) -> None:
        self.store.failures_arr[self.slot] += 1

    def reset(self) -> None:
        """Periodic state reset (paper §4.2): forget learned penalties so that
        recovered paths are re-integrated into the pool."""
        s, i = self.store, self.slot
        s.beta0_arr[i] = s.beta0_prior_arr[i]
        s.beta1_arr[i] = DEFAULT_BETA1
        s.slow_arr[i] = 0


class TelemetryStore:
    """All per-link telemetry for one engine instance as struct-of-arrays,
    plus the optional cross-process global load diffusion table (paper §4.2).

    The global table maps link_id -> queued bytes *other* engines have in
    flight on that link (populated by `repro.cluster.GlobalLoadTable` or by
    `publish_global` in shared-table setups). Because an engine schedules on
    its *local* NICs but contends with peers on the paired *remote* NICs
    (incast), the engine also tracks `remote_queued`: its own in-flight bytes
    charged against remote endpoints, so peers can see the receiver-side
    pressure through the diffusion table."""

    _FLOAT_ARRS = ("beta0_arr", "beta0_prior_arr", "beta1_arr",
                   "ewma_alpha_arr", "beta0_alpha_arr", "ewma_service_arr",
                   "bandwidth_arr")
    _INT_ARRS = ("queued_arr", "slow_arr", "completions_arr", "failures_arr")

    def __init__(self) -> None:
        self.n = 0
        self._cap = 0
        for name in self._FLOAT_ARRS:
            setattr(self, name, np.empty(0, dtype=np.float64))
        for name in self._INT_ARRS:
            setattr(self, name, np.empty(0, dtype=np.int64))
        self.excluded_arr = np.empty(0, dtype=bool)
        self._slots: Dict[int, int] = {}  # link_id -> slot (stable index map)
        self._link_ids: List[int] = []  # slot -> link_id
        self._views: List[LinkTelemetry] = []  # slot -> view
        # Shared-memory analogue: link_id -> queued bytes from OTHER engines
        self.global_load: Dict[int, int] = {}
        self.global_weight: float = 0.0  # omega_d, disabled by default
        # This engine's in-flight bytes charged to remote endpoints.
        self.remote_queued: Dict[int, int] = {}
        # Own contributions currently sitting in `global_load` (shared-table
        # mode via publish_global); subtracted on read so an engine never
        # double-counts its own load through the table.
        self._published: Dict[int, int] = {}

    # -- slot allocation -----------------------------------------------------
    def _grow(self, need: int) -> None:
        cap = max(16, 2 * self._cap, need)
        for name in self._FLOAT_ARRS + self._INT_ARRS + ("excluded_arr",):
            old = getattr(self, name)
            new = np.zeros(cap, dtype=old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)
        self._cap = cap

    def _alloc(self, view: LinkTelemetry, desc: LinkDesc, **init) -> int:
        if self.n >= self._cap:
            self._grow(self.n + 1)
        slot = self.n
        self.n += 1
        self.beta0_arr[slot] = init["beta0"]
        self.beta0_prior_arr[slot] = init["beta0_prior"]
        self.beta1_arr[slot] = init["beta1"]
        self.queued_arr[slot] = init["queued_bytes"]
        self.ewma_alpha_arr[slot] = init["ewma_alpha"]
        self.beta0_alpha_arr[slot] = init["beta0_alpha"]
        self.slow_arr[slot] = init["consecutive_slow"]
        self.completions_arr[slot] = init["completions"]
        self.failures_arr[slot] = init["failures"]
        self.ewma_service_arr[slot] = init["ewma_service_time"]
        # nominal bandwidth mirrored into the arrays (LinkDesc is frozen) so
        # the batched completion update never chases desc attributes
        self.bandwidth_arr[slot] = desc.bandwidth
        self.excluded_arr[slot] = init["excluded"]
        self._slots[desc.link_id] = slot
        self._link_ids.append(desc.link_id)
        self._views.append(view)
        return slot

    # -- registration / lookup ----------------------------------------------
    def ensure(self, desc: LinkDesc) -> LinkTelemetry:
        slot = self._slots.get(desc.link_id)
        if slot is None:
            # Topology discovery seeds the fixed-cost term with the link's
            # known base latency so cold-start predictions aren't absurd.
            return LinkTelemetry(
                desc=desc, beta0=desc.base_latency,
                beta0_prior=desc.base_latency, _store=self)
        return self._views[slot]

    def get(self, link_id: int) -> LinkTelemetry:
        return self._views[self._slots[link_id]]

    def maybe(self, link_id: int):
        slot = self._slots.get(link_id)
        return None if slot is None else self._views[slot]

    def slot_of(self, link_id: int) -> int:
        """Stable array index of a registered link (the link-index map)."""
        return self._slots[link_id]

    def effective_queue(self, tl: LinkTelemetry) -> float:
        """Local queue plus the omega-discounted global load factor. The
        local term is exact (this engine's own accounting); the global term
        is other engines' pressure, discounted by omega because the diffused
        table is periodic and therefore stale (paper §4.2)."""
        if self.global_weight <= 0.0:
            return float(tl.queued_bytes)
        return tl.queued_bytes + self.global_weight * self._foreign_load(tl.desc.link_id)

    def remote_pressure(self, link_id: int) -> float:
        """Omega-discounted global load on a path's *remote* endpoint — how
        hard other engines are hitting the receiver NIC this path pairs with.
        Zero when diffusion is off, so single-engine scoring is unchanged."""
        if self.global_weight <= 0.0:
            return 0.0
        return self.global_weight * self._foreign_load(link_id)

    def _foreign_load(self, link_id: int) -> float:
        """Other engines' bytes on a link: the table entry minus whatever
        this engine itself published into it (zero with the diffusion
        service, which already excludes own snapshots)."""
        g = self.global_load.get(link_id, 0) - self._published.get(link_id, 0)
        return float(max(g, 0))

    def foreign_load_array(self, link_ids) -> "np.ndarray":
        """Omega-weighted foreign load for a sequence of link ids (a `None`
        entry — a single-resource path with no remote endpoint — reads as
        0.0). One gather shared by the wave chooser and the decision-
        provenance snapshot (`TentPolicy.wave_inputs`), so recorded inputs
        are produced by the very code that scored the wave."""
        w = self.global_weight
        foreign = self._foreign_load
        return np.array([w * foreign(lid) if lid is not None else 0.0
                         for lid in link_ids])

    # -- cross-engine accounting (repro.cluster diffusion service) -----------
    def apply_global(self, agg: Dict[int, int]) -> None:
        """Replace the diffused global-load view wholesale. The cluster's
        `GlobalLoadTable` calls this every round (and on membership churn,
        when a departed engine's entries are garbage-collected) with the sum
        of the *other* live engines' in-horizon footprints — the single write
        point for everything `effective_queue`/`remote_pressure` read, so
        staleness pruning and departure GC cannot leave ghost pressure
        behind."""
        self.global_load = agg

    def clear_global(self) -> None:
        """Drop the diffused view entirely — what an engine leaving the
        cluster does on the way out, so a later re-attach (or standalone use)
        never schedules on a dead cluster's load table."""
        self.global_load = {}

    def charge_remote(self, link_id: int, length: int) -> None:
        self.remote_queued[link_id] = self.remote_queued.get(link_id, 0) + length

    def discharge_remote(self, link_id: int, length: int) -> None:
        left = self.remote_queued.get(link_id, 0) - length
        if left > 0:
            self.remote_queued[link_id] = left
        else:
            self.remote_queued.pop(link_id, None)

    def snapshot(self) -> Dict[int, int]:
        """This engine's total in-flight footprint per link (local queues
        plus remote-endpoint charges) — what it publishes to the cluster's
        global load table each diffusion round. One vectorized scan over the
        queue array instead of a per-link Python loop."""
        link_ids = self._link_ids
        queued = self.queued_arr
        out = {link_ids[i]: int(queued[i])
               for i in np.flatnonzero(queued[: self.n])}
        for lid, q in self.remote_queued.items():
            if q:
                out[lid] = out.get(lid, 0) + q
        return out

    def publish_global(self) -> None:
        """Shared-table mode: several stores point at one `global_load` dict
        and each writes their own queue depths in. Publishing *replaces* this
        store's previous contribution (no unbounded accumulation), and reads
        subtract it via `_published`."""
        for lid, slot in self._slots.items():
            prev = self._published.get(lid, 0)
            q = int(self.queued_arr[slot])
            if q or prev:
                self.global_load[lid] = self.global_load.get(lid, 0) - prev + q
                self._published[lid] = q

    # -- batched completion feedback (the drain half of the closed loop) -----
    @hot_path
    def on_complete_many(self, slots, lengths, queued_at_schedule, t_obs) -> None:
        """Vectorized twin of `LinkTelemetry.on_complete` over one completion
        batch, **exactly** (bit-for-bit) equal to looping `on_complete` in
        batch order.

        Per-slot the EWMA recurrence is order-sensitive, so repeated slots
        within one batch are applied in *occurrence rounds*: round r updates
        every slot's r-th occurrence, each round touches a slot at most once,
        and updates of distinct slots touch disjoint array elements — so the
        per-slot sequence is preserved while each round runs as whole-array
        float64 arithmetic (the same IEEE operations, in the same per-slot
        order, the scalar path performs). `slots`/`lengths`/
        `queued_at_schedule` are int64 arrays, `t_obs` float64, all in drain
        order."""
        slots = np.asarray(slots, dtype=np.int64)
        n = slots.shape[0]
        if n == 0:
            return
        lengths = np.asarray(lengths, dtype=np.int64)
        queued_at = np.asarray(queued_at_schedule, dtype=np.int64)
        t_obs = np.asarray(t_obs, dtype=np.float64)
        if n == 1:
            # single completion: the scalar view update beats any gather
            self._views[slots[0]].on_complete(
                int(lengths[0]), int(queued_at[0]), float(t_obs[0]))
            return
        order = np.argsort(slots, kind="stable")
        ss = slots[order]
        starts = np.empty(n, dtype=bool)
        starts[0] = True
        np.not_equal(ss[1:], ss[:-1], out=starts[1:])
        if starts.all():  # all slots distinct: one round, no indirection
            self._complete_round(slots, lengths, queued_at, t_obs)
            return
        idx = np.arange(n)
        rank = idx - np.maximum.accumulate(np.where(starts, idx, 0))
        for r in range(int(rank.max()) + 1):
            sel = order[rank == r]
            self._complete_round(
                slots[sel], lengths[sel], queued_at[sel], t_obs[sel])

    @hot_path

    def _complete_round(self, idx, lengths, queued_at, t_obs) -> None:
        """One round of the batched EWMA update: `idx` holds *distinct* store
        slots. Mirrors `LinkTelemetry.on_complete` operation for operation."""
        self.queued_arr[idx] = np.maximum(0, self.queued_arr[idx] - lengths)
        self.completions_arr[idx] += 1
        alpha = self.ewma_alpha_arr[idx]
        x = (queued_at + lengths) / self.bandwidth_arr[idx]
        b1 = self.beta1_arr[idx]
        pos = x > 0
        if pos.all():
            sample = (t_obs - self.beta0_arr[idx]) / x
            sample = np.minimum(np.maximum(sample, 0.05), 1e4)
            b1 = (1 - alpha) * b1 + alpha * sample
            self.beta1_arr[idx] = b1
        elif pos.any():
            p = np.flatnonzero(pos)
            ip = idx[p]
            sample = (t_obs[p] - self.beta0_arr[ip]) / x[p]
            sample = np.minimum(np.maximum(sample, 0.05), 1e4)
            b1p = (1 - alpha[p]) * b1[p] + alpha[p] * sample
            b1[p] = b1p
            self.beta1_arr[ip] = b1p
        resid = np.maximum(0.0, t_obs - b1 * x)
        b0a = self.beta0_alpha_arr[idx]
        self.beta0_arr[idx] = (1 - b0a) * self.beta0_arr[idx] + b0a * resid
        self.ewma_service_arr[idx] = (
            (1 - alpha) * self.ewma_service_arr[idx] + alpha * t_obs)

    # -- jitted-core state transport (repro.core.jit_core) -------------------
    def gather_complete_state(self, pad_to: int):
        """Padded float64 copies of everything `on_complete_many` reads or
        writes, in the argument order of `tent_on_complete_many_jnp`:
        `(beta0, beta1, queued, ewma_service, completions, ewma_alpha,
        beta0_alpha, bandwidth)`. `pad_to` must be > `self.n`: rows past `n`
        are inert scratch (alpha 0, bandwidth 1 — no NaNs, no visible
        updates), and row `n` is the designated scratch slot batch padding
        scatters into. Copies, never views — the kernel's write-back goes
        through `scatter_complete_state`."""
        n = self.n
        out = []
        for name, fill in (("beta0_arr", 0.0), ("beta1_arr", 1.0),
                           ("queued_arr", 0.0), ("ewma_service_arr", 0.0),
                           ("completions_arr", 0.0), ("ewma_alpha_arr", 0.0),
                           ("beta0_alpha_arr", 0.0), ("bandwidth_arr", 1.0)):
            arr = np.full(pad_to, fill, dtype=np.float64)
            arr[:n] = getattr(self, name)[:n]
            out.append(arr)
        return tuple(out)

    def scatter_complete_state(self, beta0, beta1, queued, ewma_service,
                               completions) -> None:
        """Write back the five state vectors `on_complete_many` mutates from
        a jitted-kernel result (padded rows ignored). Queue depths and
        completion counts travel as float64 but are exact — the engine's
        byte counts stay far below 2**53 — so the int64 cast round-trips
        bit-identically with the numpy path."""
        n = self.n
        self.beta0_arr[:n] = beta0[:n]
        self.beta1_arr[:n] = beta1[:n]
        self.queued_arr[:n] = np.asarray(queued[:n], dtype=np.float64).astype(np.int64)
        self.ewma_service_arr[:n] = ewma_service[:n]
        self.completions_arr[:n] = np.asarray(
            completions[:n], dtype=np.float64).astype(np.int64)

    # -- bulk state ----------------------------------------------------------
    def reset_all(self) -> None:
        n = self.n
        self.beta0_arr[:n] = self.beta0_prior_arr[:n]
        self.beta1_arr[:n] = DEFAULT_BETA1
        self.slow_arr[:n] = 0

    def excluded_link_ids(self) -> List[int]:
        """Link ids of all currently soft-excluded rails — one vectorized
        scan of the exclusion array (the prober polls this every round)."""
        link_ids = self._link_ids
        return [link_ids[i] for i in np.flatnonzero(self.excluded_arr[: self.n])]

    def items(self):
        # a re-iterable sequence, like the dict view this used to return
        return list(zip(self._link_ids, self._views))
