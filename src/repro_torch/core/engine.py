"""TENT engine: declarative BatchTransfer API over the execution pipeline.

Applications declare *what* moves (`allocate_batch` / `submit_transfer` /
`wait`); the engine decides *how*: Phase 1 resolves a ranked transport plan
(plan.py), Phase 2 sprays telemetry-scheduled slices across rails
(scheduler.py), Phase 3 absorbs faults in the data plane (resilience.py).
Completion is exposed through hierarchical counters: applications observe
only "batch X has N slices remaining" (paper §4.4).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import events as OBS
from ..obs import spans as _spans
from ..analysis import hot_path
from .fabric import Fabric, FabricConfig
from .plan import Orchestrator, Stage, StageCandidates, TransportPlan, build_stage_candidates
from .resilience import HealthConfig, HealthMonitor
from .scheduler import Policy, TentPolicy, make_policy
from .segments import Segment, SegmentManager
from .slicing import DEFAULT_MAX_SLICES, DEFAULT_SLICE_BYTES, decompose
from .telemetry import TelemetryStore
from .topology import DEFAULT_TIER_PENALTY, FabricSpec, Topology
from .transports import WirePath, load_backends
from .types import (
    BatchState,
    EXHAUSTED_RETRIES,
    Location,
    Slice,
    SliceState,
    TentError,
    TransferRequest,
    next_batch_id,
    next_transfer_id,
)


# Runs shorter than this go through the scalar chooser: the vectorized wave
# kernel and the scalar path pick bit-identical rails, so the cutover is a
# pure cost decision — below it, array gather/scatter setup costs more than
# it saves (the steady-state closed loop re-dispatches one slice per
# completion, which must stay on the cheap path). WAVE_MIN is the neutral
# starting point; unless `EngineConfig.wave_min` pins it, each engine tunes
# its crossover online within [WAVE_MIN_FLOOR, WAVE_MIN_CEIL] from the run
# lengths and completion-batch sizes it actually observes (burst-heavy
# traffic amortizes kernel setup well -> lower crossover; a trickle of
# single completions cannot -> higher). Because both paths pick identical
# rails, the tuner can never change a scheduling decision, only its cost.
WAVE_MIN = 4
WAVE_MIN_FLOOR = 2
WAVE_MIN_CEIL = 8


@dataclasses.dataclass
class EngineConfig:
    policy: str = "tent"
    slice_bytes: int = DEFAULT_SLICE_BYTES
    max_slices: int = DEFAULT_MAX_SLICES
    max_inflight: int = 256  # worker-ring capacity (paper §4.4)
    gamma: float = 0.05
    tier_penalty: Optional[Dict[int, float]] = None
    reset_interval: float = 30.0  # periodic state reset (paper §4.2)
    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)
    # datapath overheads (paper §4.4): per-post submission cost, amortized by
    # opportunistic batched posting of `post_batch` work requests.
    submission_overhead: float = 1.5e-6
    post_batch: int = 16
    global_diffusion_weight: float = 0.0  # omega, off by default
    # hot-path controls. `wave` schedules pending slices a batch at a time
    # through the vectorized chooser (`TentPolicy.choose_wave`), falling back
    # to the scalar path only for retries/substitutions; `candidate_cache`
    # reuses the per-plan-stage candidate sets instead of re-enumerating wire
    # paths per slice. Both default on; turning both off reproduces the
    # pre-wave one-slice-at-a-time hot path (the `benchmarks/spray_hotpath`
    # comparator) with bit-identical scheduling decisions.
    wave: bool = True
    candidate_cache: bool = True
    # `wave_complete` batches the *drain* half of the closed loop: the fabric
    # delivers all completions landing at one virtual timestamp in a single
    # call, telemetry EWMA updates run vectorized (`on_complete_many`), and
    # failure fan-out retries flush through one batched post. Off reproduces
    # the per-completion scalar drain with bit-identical outcomes (pinned in
    # tests/test_complete_parity.py). `wave_min` pins the scalar/wave
    # dispatch crossover to a fixed value for determinism experiments; None
    # (default) lets the engine adapt it online from observed run lengths
    # and completion-batch sizes.
    wave_complete: bool = True
    wave_min: Optional[int] = None
    # `jit_core` routes the two array kernels of the closed loop — the wave
    # chooser and the batched completion drain — through fixed-shape fp64
    # CUDA kernels (repro_torch.core.jit_core), padded to power-of-two shape
    # buckets, bit-identical to the numpy path. The scalar/wave Python path
    # remains in charge of small batches (own online-tuned crossover,
    # mirroring `wave_min`), staged hops, retries, and app callbacks; engines
    # with a FlightRecorder attached turn it off (see `attach_recorder`).
    # The device is the engine's `device` argument (None = CUDA, which
    # raises without a card). Off by default.
    jit_core: bool = False
    # Run the fabric event loop on the calendar queue (bucketed timestamp
    # wheel, `repro_torch.core.calqueue`) instead of the binary heap. Bit-identical
    # pop order (pinned across the library in tests/test_calendar_parity.py);
    # O(1) amortized per event, which pays off at production-scale serving
    # streams (10^5+ in-flight events). Only consulted when the engine builds
    # its own fabric — a fabric passed in keeps its own FabricConfig.
    calendar_queue: bool = False


@dataclasses.dataclass
class _TransferCB:
    req: TransferRequest
    plan: TransportPlan
    remaining: int
    batch_id: int
    # (route_idx, hop) -> StageCandidates: per-transfer memo over the
    # engine-wide stage cache, so the wave grouping pays one cheap int-tuple
    # lookup per slice instead of hashing Stage locations
    stages: Dict[Tuple[int, int], StageCandidates] = dataclasses.field(
        default_factory=dict)
    # (src_seg, dst_seg, dst_is_phantom) resolved once at submit: every
    # slice of the transfer finishes against the same segments, so the
    # drain loop never re-resolves them
    segs: tuple = ()


@dataclasses.dataclass
class _BatchCB:
    batch_id: int
    state: BatchState = BatchState.OPEN
    remaining_slices: int = 0  # hierarchical top-level counter
    transfers: List[_TransferCB] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    completed_at: float = 0.0
    error: Optional[str] = None
    callbacks: List[Callable[["_BatchCB"], None]] = dataclasses.field(default_factory=list)

    @property
    def bytes_total(self) -> int:
        return sum(t.req.length for t in self.transfers)


@dataclasses.dataclass
class BatchResult:
    batch_id: int
    ok: bool
    submitted_at: float
    completed_at: float
    bytes: int
    error: Optional[str] = None

    @property
    def elapsed(self) -> float:
        return self.completed_at - self.submitted_at

    @property
    def throughput(self) -> float:
        return self.bytes / max(self.elapsed, 1e-12)


@dataclasses.dataclass(slots=True)
class _InflightSlice:
    sl: Slice
    tcb: _TransferCB
    path: WirePath
    t_pred: float
    queued_at_schedule: int
    scheduled_at: float
    slot: int = -1  # local link's telemetry-store slot (batched-drain gather)
    # pre-packed batched-drain columns, built once at post time so the drain
    # gathers a whole run with one zip instead of per-item attribute chases:
    # (slot, length, queued_at_schedule, scheduled_at, t_pred, local_link,
    #  remote_link or -1)
    drain: tuple = ()


class TentEngine:
    """One engine instance (one process in the paper's deployment model)."""

    def __init__(
        self,
        spec: Optional[FabricSpec] = None,
        *,
        topology: Optional[Topology] = None,
        fabric: Optional[Fabric] = None,
        segments: Optional[SegmentManager] = None,
        config: Optional[EngineConfig] = None,
        seed: int = 0,
        name: str = "engine",
        device=None,
    ):
        """`device` is where the jitted core runs when `config.jit_core` is
        on (None = CUDA, which raises without a card); it is not used
        otherwise."""
        self.name = name  # tenant tag on a shared fabric (cluster deployments)
        if topology is None:
            topology = Topology(spec or FabricSpec())
        self.topology = topology
        self.config = config or EngineConfig()
        if fabric is None:
            fabric = Fabric(
                topology, seed=seed,
                config=FabricConfig(event_queue="calendar")
                if self.config.calendar_queue else None)
        self.fabric = fabric
        self.segments = segments or SegmentManager()
        self.backends = load_backends(topology)
        self.orchestrator = Orchestrator(self.backends)
        self.store = TelemetryStore()
        self.store.global_weight = self.config.global_diffusion_weight
        self.policy = self._make_policy(self.config)
        self.health = HealthMonitor(self.store, self.config.health)
        self._batches: Dict[int, _BatchCB] = {}
        self._pending: Deque[Tuple[Slice, _TransferCB]] = deque()
        self._inflight = 0
        self._open_work = 0  # batches submitted but not completed
        self._reset_timer_armed = False
        self._probe_timer_armed = False
        # hot-path state: the engine-wide per-stage candidate cache, the
        # amortized per-post submission latency, and whether the policy has
        # a vectorized wave chooser (only TentPolicy does; the baseline
        # ablations run the scalar loop over the same cached candidates)
        self._stage_cache: Dict[Stage, StageCandidates] = {}
        self._post_overhead = (
            self.config.submission_overhead / max(self.config.post_batch, 1))
        self._tier_penalty = (
            self.policy.tier_penalty if isinstance(self.policy, TentPolicy) else None)
        self._wave_policy = self.config.wave and isinstance(self.policy, TentPolicy)
        # scalar/wave dispatch crossover: pinned by config, or tuned online
        # from run-length / completion-batch EWMAs (`_tune_wave_min`)
        self._adaptive_wave_min = self.config.wave_min is None
        self._wave_min = (
            WAVE_MIN if self._adaptive_wave_min else max(1, self.config.wave_min))
        self._run_ewma = 0.0
        self._drain_ewma = 0.0
        # jitted-core adapter (EngineConfig.jit_core): None = scalar/numpy
        # path everywhere. Requires the wave-capable TentPolicy — baseline
        # ablation policies have no vectorized chooser to fuse.
        self._jit = None
        if self.config.jit_core and self._wave_policy:
            from .jit_core import EngineJitCore
            self._jit = EngineJitCore(self.policy, self.store, device=device)
        # armed only inside the batched failure drain: scalar `_issue` calls
        # append their post specs here instead of posting, and the drain
        # flushes them through one `post_many` (stream-identical to the
        # deferred sequential posts)
        self._post_buffer: Optional[list] = None
        self._cb_batches = 0  # live batches with registered done-callbacks
        # observability
        self.slices_retried = 0
        self.backend_substitutions = 0
        self.slices_issued = 0
        self.waves = 0
        self.completions_drained = 0
        self.completion_batches = 0
        # flight recorder (repro.obs): None = tracing off. Every record site
        # is one `self._rec` load and an `is not None` branch per *batch*
        # (wave / drain run / declared intent), never per slice — the
        # zero-cost-when-off contract the hot-path bench gates pin.
        self._rec = None
        if self.config.wave_complete:
            self.fabric.register_completion_sink(
                self._on_wire_done, self._on_wire_done_many)
        # pre-register telemetry for every link so resets/benchmarks see all
        for link in topology.links:
            self.store.ensure(link)

    def _make_policy(self, cfg: EngineConfig) -> Policy:
        if cfg.policy == "tent":
            return TentPolicy(
                tier_penalty=cfg.tier_penalty or dict(DEFAULT_TIER_PENALTY),
                gamma=cfg.gamma,
                store=self.store,
            )
        return make_policy(cfg.policy)

    def attach_recorder(self, rec) -> None:
        """Attach a `repro.obs.FlightRecorder` to this engine, its fabric,
        and its health monitor. Recording is strictly passive — appends
        inside existing callbacks, batch-granular — and never schedules
        fabric events, so attaching cannot perturb the simulation (pinned by
        the tracing-ON/OFF report-parity tests)."""
        self._rec = rec
        self.fabric.attach_recorder(rec)
        self.health.attach_recorder(rec, self.fabric, owner=self.name)
        if self._jit is not None:
            # Recorder appends (wave provenance snapshots, drain payloads)
            # happen on the host path only. Tracing therefore forces the
            # scalar/numpy path, loudly; reports stay identical because both
            # paths are bit-exact (tests/test_torch_obs.py pins this).
            import warnings
            warnings.warn(
                f"engine {self.name!r}: FlightRecorder attached with "
                "jit_core enabled; disabling the jitted core for this "
                "engine (record sites run on the host path only)",
                RuntimeWarning, stacklevel=2)
            self._jit = None

    def register_metrics(self, reg) -> None:
        """Expose the engine's scheduling counters as lazy gauges on a
        `repro.obs.MetricsRegistry`. The counters stay plain int attributes
        (the hot path keeps its bare `+= 1`); the registry reads them at
        `collect()` time."""
        reg.gauge("slices_issued", lambda: float(self.slices_issued))
        reg.gauge("waves", lambda: float(self.waves))
        reg.gauge("completions_drained",
                  lambda: float(self.completions_drained))
        reg.gauge("completion_batches",
                  lambda: float(self.completion_batches))

    # ------------------------------------------------------------------ API
    def register_segment(self, location: Location, length: int, **kw) -> Segment:
        seg = self.segments.register(location, length, **kw)
        # derive transport capabilities from the topology (paper §3.1)
        caps = [
            be.name
            for be in self.backends.values()
            if any(
                be.feasible(location, other.location) or be.feasible(other.location, location)
                for other in self.segments.all_segments()
            )
        ]
        self.segments.set_transports(seg.segment_id, caps)
        return seg

    def allocate_batch(self) -> int:
        bc = _BatchCB(batch_id=next_batch_id())
        self._batches[bc.batch_id] = bc
        return bc.batch_id

    def submit_transfer(
        self,
        batch_id: int,
        transfers: Sequence[Tuple[int, int, int, int, int]],
    ) -> None:
        """transfers: (src_segment, src_offset, dst_segment, dst_offset, length)."""
        with _spans.span("engine.submit"):
            self._submit(batch_id, transfers)

    def _submit(self, batch_id: int,
                transfers: Sequence[Tuple[int, int, int, int, int]]) -> None:
        """Plan, decompose and dispatch the first wave of `submit_transfer`."""
        bc = self._batches[batch_id]
        if bc.state not in (BatchState.OPEN, BatchState.SUBMITTED):
            raise TentError("BatchClosed", f"batch {batch_id} is {bc.state}")
        first_submit = bc.state == BatchState.OPEN
        if first_submit:
            bc.state = BatchState.SUBMITTED
            bc.submitted_at = self.fabric.now
            self._open_work += 1
            self._arm_reset_timer()
        n_before = len(bc.transfers)
        for (src, soff, dst, doff, length) in transfers:
            req = TransferRequest(
                transfer_id=next_transfer_id(),
                src_segment=src, src_offset=soff,
                dst_segment=dst, dst_offset=doff, length=length,
            )
            src_seg, dst_seg = self.segments.get(src), self.segments.get(dst)
            # validate the whole declared range up front: phantom segments
            # never materialize bytes, so submit time is where out-of-range
            # offsets must fail loudly (real segments re-check per slice
            # inside read/write as before)
            src_seg._check_range(soff, length)
            dst_seg._check_range(doff, length)
            plan = self.orchestrator.resolve(src_seg, dst_seg)
            slices = decompose(
                req, batch_id,
                slice_bytes=self.config.slice_bytes, max_slices=self.config.max_slices,
            )
            tcb = _TransferCB(req=req, plan=plan, remaining=len(slices), batch_id=batch_id)
            tcb.segs = (src_seg, dst_seg, dst_seg.phantom)
            bc.transfers.append(tcb)
            bc.remaining_slices += len(slices)
            for sl in slices:
                sl.submitted_at = self.fabric.now
                self._pending.append((sl, tcb))
        rec = self._rec
        if rec is not None:
            new = bc.transfers[n_before:]
            rec.append(OBS.INTENT, self.fabric.now, {
                "engine": self.name, "batch": rec.bid(batch_id),
                "transfers": len(new),
                "slices": sum(t.remaining for t in new),
                "bytes": sum(t.req.length for t in new)})
        self._dispatch()

    def on_batch_done(self, batch_id: int, fn: Callable[[BatchResult], None]) -> None:
        bc = self._batches[batch_id]
        if not bc.callbacks and bc.state in (BatchState.OPEN, BatchState.SUBMITTED):
            # live batches carrying callbacks force the batched drain to
            # project batch completions while scanning (the callback cut);
            # while this is zero the scan takes the bookkeeping-free path
            self._cb_batches += 1
        bc.callbacks.append(lambda b: fn(self._result(b)))

    def get_transfer_status(self, batch_id: int) -> Tuple[BatchState, int]:
        bc = self._batches[batch_id]
        return bc.state, bc.remaining_slices

    def wait(self, batch_id: int, *, max_events: int = 50_000_000) -> BatchResult:
        bc = self._batches[batch_id]
        n = 0
        with _spans.span("engine.run"):
            while bc.state == BatchState.SUBMITTED:
                if not self.fabric.step():
                    raise TentError("Stalled", f"batch {batch_id} stuck with no events")
                n += 1
                if n > max_events:
                    raise TentError("Livelock", f"batch {batch_id} exceeded event budget")
        return self._result(bc)

    def run_until_idle(self) -> None:
        with _spans.span("engine.run"):
            self.fabric.run_until_idle()

    def transfer_sync(self, src: int, soff: int, dst: int, doff: int, length: int) -> BatchResult:
        b = self.allocate_batch()
        self.submit_transfer(b, [(src, soff, dst, doff, length)])
        return self.wait(b)

    def _result(self, bc: _BatchCB) -> BatchResult:
        return BatchResult(
            batch_id=bc.batch_id,
            ok=bc.state == BatchState.DONE,
            submitted_at=bc.submitted_at,
            completed_at=bc.completed_at,
            bytes=bc.bytes_total,
            error=bc.error,
        )

    # ------------------------------------------------------------- dispatch
    @hot_path
    def _dispatch(self) -> None:
        """`_dispatch_pending` when there is work to issue; with spans on,
        its time is a `dispatch_ns` accumulator."""
        if not self._pending or self._inflight >= self.config.max_inflight:
            return
        rec = _spans.active
        if rec is None:
            self._dispatch_pending()
            return
        t0 = rec.begin()
        self._dispatch_pending()
        rec.end(t0, "dispatch_ns", "dispatch_n", 1)

    @hot_path
    def _dispatch_pending(self) -> None:
        """Drain the pending ring into the fabric, a wave at a time.

        Pops up to the worker-ring headroom worth of slices, groups
        consecutive runs that share a plan-stage candidate set, and issues
        each run in one batch: the TENT policy scores the whole run through
        the vectorized wave chooser (sequential line-11 queue charges
        preserved), baseline policies loop the scalar chooser over the same
        cached candidates, and the chosen paths are posted through one
        batched fabric call. Retries, staged-hop continuations, and backend
        substitutions keep using the scalar `_issue` path."""
        if not self.config.wave:
            while self._pending and self._inflight < self.config.max_inflight:
                sl, tcb = self._pending.popleft()
                if self._batches[tcb.batch_id].state != BatchState.SUBMITTED:
                    continue  # batch already failed; drop
                self._issue(sl, tcb, retry_exclude=())
            return
        while self._pending and self._inflight < self.config.max_inflight:
            budget = self.config.max_inflight - self._inflight
            wave: List[Tuple[Slice, _TransferCB]] = []
            while self._pending and len(wave) < budget:
                sl, tcb = self._pending.popleft()
                if self._batches[tcb.batch_id].state != BatchState.SUBMITTED:
                    continue  # batch already failed; drop
                wave.append((sl, tcb))
            if not wave:
                return
            self._issue_wave(wave)

    def _stage_cands(self, tcb: _TransferCB, hop: int) -> StageCandidates:
        """The candidate set for a transfer's current (route, hop) stage,
        resolved through the per-transfer memo and the engine-wide stage
        cache (stages are static given the topology, so one build serves
        every slice that ever crosses the stage)."""
        key = (tcb.plan.route_idx, hop)
        sc = tcb.stages.get(key)
        if sc is not None:
            return sc
        stage = tcb.plan.current.stages[hop]
        sc = self._stage_cache.get(stage) if self.config.candidate_cache else None
        if sc is None:
            sc = build_stage_candidates(
                stage, self.backends, self.store,
                tier_penalty=self._tier_penalty,
                post_overhead=self._post_overhead,
            )
            if self.config.candidate_cache:
                self._stage_cache[stage] = sc
        tcb.stages[key] = sc
        return sc

    def _issue_wave(self, wave: List[Tuple[Slice, _TransferCB]]) -> None:
        """Issue one popped wave: group by stage, choose in batch, post in
        batch. When a slice has no usable candidates (empty backend or
        tier-infeasible set) the slices after it are pushed back onto the
        pending ring and the problem slice takes the scalar substitution
        path — exactly the order the one-slice loop produced."""
        i, n = 0, len(wave)
        # set once a scalar _issue ran inside this wave: only then can a
        # batch have failed between pop time and a later run's posting
        dirty = False
        while i < n:
            sl, tcb = wave[i]
            sc = self._stage_cands(tcb, sl.hop)
            if not sc.paths:
                self._requeue_front(wave[i + 1:])
                # a scalar issue earlier in this wave may have failed this
                # slice's batch; the one-slice loop would drop it at pop
                # time, so the candidate-less fallback must not resurrect it
                # through the substitution path (it could post a dead
                # batch's slices on the next-best transport)
                if not dirty or \
                        self._batches[tcb.batch_id].state == BatchState.SUBMITTED:
                    self._issue(sl, tcb, retry_exclude=())
                return
            j = i + 1
            hop = sl.hop
            while j < n:
                sl2, tcb2 = wave[j]
                # same transfer, same hop -> same stage by construction; only
                # cross-transfer neighbours need the memo lookup
                if not (tcb2 is tcb and sl2.hop == hop) and \
                        self._stage_cands(tcb2, sl2.hop) is not sc:
                    break
                j += 1
            run = wave[i:j]
            if dirty:
                # a scalar issue earlier in this wave may have failed a
                # batch via exhausted substitution; drop its slices exactly
                # like the one-slice loop's pop-time check would
                run = [e for e in run
                       if self._batches[e[1].batch_id].state == BatchState.SUBMITTED]
                if not run:
                    i = j
                    continue
            if self._adaptive_wave_min:
                self._run_ewma = 0.75 * self._run_ewma + 0.25 * len(run)
                self._tune_wave_min()
            if self._wave_policy and len(run) >= self._wave_min:
                lengths = np.fromiter(
                    (s.length for s, _ in run), dtype=np.int64, count=len(run))
                rec = self._rec
                # decision provenance: snapshot the chooser's inputs *before*
                # the line-11 charges mutate the queue array (one dict of
                # fresh arrays per wave, nothing per slice)
                prov = self.policy.wave_inputs(sc) if rec is not None else None
                jit = self._jit
                if jit is not None and len(run) >= jit.min_batch:
                    choices, queued_at = jit.choose_wave(sc, lengths)
                else:
                    choices, queued_at = self.policy.choose_wave(sc, lengths)
                if rec is not None:
                    # slice refs, not ids: interning is deferred to the
                    # recorder's first read so the timed path stays O(1)
                    # dict-free per slice
                    rec.append(OBS.WAVE, self.fabric.now, {
                        "engine": self.name,
                        "slices": [s for s, _ in run],
                        "lengths": lengths,
                        "choices": choices,
                        "queued_at": queued_at,
                        "inputs": prov})
                if choices[-1] < 0:
                    # first infeasible slice ends the kernel's run: post what
                    # was scheduled, hand the bad slice to the scalar
                    # substitution path, push the rest back in order
                    k = int(np.argmax(choices < 0))
                    self._post_run(run[:k], sc, choices, queued_at)
                    self._requeue_front(list(run[k + 1:]) + list(wave[j:]))
                    bad_sl, bad_tcb = run[k]
                    self._issue(bad_sl, bad_tcb, retry_exclude=())
                    return
                self._post_run(run, sc, choices, queued_at)
            else:
                dirty = True
                for sl2, tcb2 in run:
                    # a substitution failure earlier in this run may have
                    # failed the batch; drop its remaining slices like the
                    # one-slice loop's pop-time check did
                    if self._batches[tcb2.batch_id].state != BatchState.SUBMITTED:
                        continue
                    self._issue(sl2, tcb2, retry_exclude=())
            i = j

    def _tune_wave_min(self) -> None:
        """Adapt the scalar/wave crossover online. The wave kernel pays an
        O(n_cands) array gather/scatter setup once per run while the scalar
        chooser pays O(n_cands) per slice, so the crossover should sit where
        typical runs amortize the setup: sustained long dispatch runs or fat
        completion batches (bursty traffic) push it to the floor, a trickle
        of single-slice redispatches (steady-state closed loop) pushes it to
        the ceiling. Deterministic given the virtual clock — the signal is
        structural (batch sizes), never wall-clock."""
        signal = self._run_ewma if self._run_ewma > self._drain_ewma \
            else self._drain_ewma
        if signal >= 2.0 * WAVE_MIN:
            self._wave_min = WAVE_MIN_FLOOR
        elif signal <= 0.5 * WAVE_MIN:
            self._wave_min = WAVE_MIN_CEIL
        else:
            self._wave_min = WAVE_MIN
        if self._jit is not None:
            # same structural signal drives the numpy/jit crossover
            self._jit.tune(signal)

    @property
    def wave_min(self) -> int:
        """The scalar/wave dispatch crossover currently in force (fixed when
        `EngineConfig.wave_min` pins it, otherwise the tuner's latest
        estimate)."""
        return self._wave_min

    def _requeue_front(self, items: Sequence[Tuple[Slice, _TransferCB]]) -> None:
        if items:
            self._pending.extendleft(reversed(items))

    def _post_run(
        self,
        run: Sequence[Tuple[Slice, _TransferCB]],
        sc: StageCandidates,
        choices,
        queued_at,
    ) -> None:
        """Build the inflight records for one scheduled run and enqueue the
        whole run through the fabric's batched post (one shared completion
        callback; no per-slice closures)."""
        if not len(run):
            return
        store = self.store
        beta0, beta1 = store.beta0_arr, store.beta1_arr
        charge_remote = store.charge_remote
        paths, slots, extras = sc.paths, sc.local_slot, sc.extra_latency
        bws = sc.bandwidth
        now = self.fabric.now
        inflight_state = SliceState.INFLIGHT
        specs = []
        append = specs.append
        for k, (sl, tcb) in enumerate(run):
            ci = choices[k]
            path = paths[ci]
            slot = slots[ci]
            q_after = int(queued_at[k])  # A_d at schedule time (incl. this slice)
            t_pred = beta0[slot] + beta1[slot] * q_after / bws[ci]
            inf = _InflightSlice(sl, tcb, path, t_pred, q_after, now, slot)
            # per-slice, not per-run: transfers at different route_idx can
            # share one stage by value, and the substitution-follow logic
            # compares sl.route_idx against the slice's OWN plan
            sl.route_idx = tcb.plan.route_idx
            sl.state = inflight_state
            local_link = path.local.link_id
            sl.scheduled_link = local_link
            remote = path.remote
            if remote is not None:
                # receiver-side accounting: published to the cluster's global
                # load table so peer engines see the incast forming (§4.2)
                rid = remote.link_id
                charge_remote(rid, sl.length)
                inf.drain = (slot, sl.length, q_after, now, t_pred,
                             local_link, rid)
                append((local_link, rid, sl.length,
                        extras[ci], path.bw_factor, inf))
            else:
                inf.drain = (slot, sl.length, q_after, now, t_pred,
                             local_link, -1)
                append((local_link, None, sl.length,
                        extras[ci], path.bw_factor, inf))
        self._inflight += len(specs)
        self.slices_issued += len(specs)
        self.waves += 1
        self.fabric.post_many(specs, self._on_wire_done, tenant=self.name)

    def _issue(self, sl: Slice, tcb: _TransferCB, *, retry_exclude: Sequence[int]) -> None:
        """Schedule one slice hop via the policy (or the reliability-first
        retry chooser) and post it to the fabric — the scalar path, kept for
        retries, staged-hop continuations, and backend substitutions."""
        try:
            sc = self._stage_cands(tcb, sl.hop)
            cands = sc.cands
            if retry_exclude or sl.attempts > 0:
                chosen = self.health.choose_retry(cands, retry_exclude)
                if chosen is None:
                    raise TentError("NoRetryCandidate", "all rails excluded")
                chosen.telemetry.on_schedule(sl.length)  # retries still charge queues
            else:
                chosen = self.policy.choose(cands, sl.length)
        except TentError:
            # No candidates on this backend: substitute the whole transport.
            if tcb.plan.substitute():
                self.backend_substitutions += 1
                rec = self._rec
                if rec is not None:
                    rec.append(OBS.SUBSTITUTE, self.fabric.now, {
                        "engine": self.name, "slice": sl,
                        "batch": rec.bid(tcb.batch_id)})
                sl.hop = 0
                self._issue(sl, tcb, retry_exclude=())
                return
            self._fail_batch(tcb, EXHAUSTED_RETRIES)
            return

        sl.route_idx = tcb.plan.route_idx
        path = sc.path_by_link[chosen.link_id]
        tl = chosen.telemetry
        queued_at_schedule = int(tl.queued_bytes)  # includes this slice (line 11)
        t_pred = tl.beta0 + tl.beta1 * queued_at_schedule / tl.desc.bandwidth
        now = self.fabric.now
        inf = _InflightSlice(
            sl=sl, tcb=tcb, path=path, t_pred=t_pred,
            queued_at_schedule=queued_at_schedule, scheduled_at=now,
            slot=tl.slot,
        )
        sl.state = SliceState.INFLIGHT
        sl.scheduled_link = path.local.link_id
        self._inflight += 1
        self.slices_issued += 1
        remote_link = path.remote.link_id if path.remote is not None else None
        inf.drain = (tl.slot, sl.length, queued_at_schedule, now, t_pred,
                     path.local.link_id,
                     remote_link if remote_link is not None else -1)
        if remote_link is not None:
            # receiver-side accounting: published to the cluster's global
            # load table so peer engines see the incast forming (§4.2)
            self.store.charge_remote(remote_link, sl.length)
        rec = self._rec
        if rec is not None:
            rec.append(OBS.POST, now, {
                "engine": self.name, "slice": sl,
                "link": path.local.link_id,
                "remote": remote_link if remote_link is not None else -1,
                "hop": sl.hop, "attempt": sl.attempts,
                "t_pred": t_pred, "queued": queued_at_schedule})
        buf = self._post_buffer
        if buf is not None:
            # batched failure drain: defer the post into the drain's single
            # post_many flush (stream- and event-identical to posting here)
            buf.append((path.local.link_id, remote_link, sl.length,
                        path.extra_latency + self._post_overhead,
                        path.bw_factor, inf))
            return
        self.fabric.post(
            path.local.link_id,
            remote_link,
            sl.length,
            self._on_wire_done,
            extra_latency=path.extra_latency + self._post_overhead,
            bw_scale=path.bw_factor,
            tenant=self.name,
            tag=inf,
        )

    def _on_wire_done(self, tag: "_InflightSlice", ok: bool, t0: float,
                      t1: float, err: str) -> None:
        """Shared tagged completion for every posted slice (wave or scalar):
        the fabric hands the `_InflightSlice` back, so posting needs no
        per-slice closure. With spans on, its time is a `drain_ns`
        accumulator."""
        rec = _spans.active
        t0 = rec.begin() if rec is not None else 0
        self.completions_drained += 1
        self._on_wire_complete(tag, ok, t1, err)
        if rec is not None:
            rec.end(t0, "drain_ns", "drain_n", 1)

    # ----------------------------------------------------------- completion
    def _on_wire_complete(self, inf: _InflightSlice, ok: bool, t_end: float, err: str) -> None:
        """Scalar completion drain: one slice's full feedback sequence
        (telemetry EWMA / health / continuation or retry) plus a ring
        redispatch. The batched drain decomposes into exactly these handlers
        and must stay in lockstep with them."""
        self._inflight -= 1
        if inf.path.remote is not None:
            self.store.discharge_remote(inf.path.remote.link_id, inf.sl.length)
        if ok:
            self._handle_wire_success(inf, t_end)
        else:
            self._handle_wire_failure(inf, t_end)
        self._dispatch()

    def _handle_wire_success(self, inf: _InflightSlice, t_end: float) -> None:
        sl, tcb, tl = inf.sl, inf.tcb, self.store.get(inf.path.local.link_id)
        t_obs = t_end - inf.scheduled_at
        tl.on_complete(sl.length, inf.queued_at_schedule, t_obs)
        self.health.observe(tl.desc.link_id, t_obs, inf.t_pred)
        if tl.excluded:
            self._arm_probe_timer()  # implicit exclusion -> start probing
        route = tcb.plan.current
        rec = self._rec
        if rec is not None:
            rec.append(OBS.COMPLETE, t_end, {
                "engine": self.name,
                "slices": [sl],
                "links": (inf.path.local.link_id,),
                "scheduled": (inf.scheduled_at,),
                "t_pred": (inf.t_pred,),
                "lengths": (sl.length,),
                "hop": sl.hop})
        if sl.hop + 1 < len(route.stages):
            sl.hop += 1
            self._issue(sl, tcb, retry_exclude=())  # pipelined staged hop
        else:
            self._finish_slice(sl, tcb, t_end)

    def _handle_wire_failure(self, inf: _InflightSlice, t_end: float) -> None:
        sl, tcb, tl = inf.sl, inf.tcb, self.store.get(inf.path.local.link_id)
        rec = self._rec
        if rec is not None:
            rec.append(OBS.FAIL, t_end, {
                "engine": self.name, "slice": sl,
                "link": inf.path.local.link_id,
                "remote": (inf.path.remote.link_id
                           if inf.path.remote is not None else -1),
                "attempt": sl.attempts})
        tl.on_cancel(sl.length)
        self.health.on_path_failure(
            inf.path.local.link_id,
            inf.path.remote.link_id if inf.path.remote is not None else None,
        )
        self._arm_probe_timer()
        sl.attempts += 1
        self.slices_retried += 1
        if sl.attempts > self.config.health.retry_limit:
            if sl.route_idx != tcb.plan.route_idx:
                # another slice already substituted the backend: follow
                sl.hop = 0
                sl.attempts = 0
                self._issue(sl, tcb, retry_exclude=())
            elif tcb.plan.substitute():
                self.backend_substitutions += 1
                if rec is not None:
                    rec.append(OBS.SUBSTITUTE, t_end, {
                        "engine": self.name, "slice": sl,
                        "batch": rec.bid(tcb.batch_id)})
                sl.hop = 0
                sl.attempts = 0
                self._issue(sl, tcb, retry_exclude=())
            else:
                self._fail_batch(tcb, EXHAUSTED_RETRIES)
        else:
            # In-band recovery: reschedule on an alternative path now.
            self._issue(sl, tcb, retry_exclude=(inf.path.local.link_id,))

    # ------------------------------------------------- batched completion
    @hot_path
    def _on_wire_done_many(self, ops, now: float) -> None:
        """Batched completion drain (`EngineConfig.wave_complete`): the
        fabric delivers every tagged completion landing at one virtual
        timestamp in a single call, in heap (== scalar delivery) order.

        The walk peels the batch into maximal *vectorizable runs* —
        consecutive successful final-hop completions while the pending ring
        is empty — which drain through one `TelemetryStore.on_complete_many`
        + `HealthMonitor.observe_many` + one redispatch, and consecutive
        *failure runs*, which keep exact per-item bookkeeping order but
        flush their retry posts through one batched `post_many`. Anything
        else (staged-hop continuations, a non-empty pending ring, app
        callbacks that may submit new work mid-batch) falls back to the
        scalar per-item sequence, so the two drains stay bit-identical
        (pinned in tests/test_complete_parity.py). With spans on, its time
        is a `drain_ns` accumulator."""
        rec = _spans.active
        t0 = rec.begin() if rec is not None else 0
        n = len(ops)
        self.completions_drained += n
        self.completion_batches += 1
        if self._adaptive_wave_min:
            self._drain_ewma = 0.75 * self._drain_ewma + 0.25 * n
            self._tune_wave_min()
        batches = self._batches
        i = 0
        while i < n:
            op = ops[i]
            inf = op.tag
            if op.failed:
                if self._pending:
                    self._on_wire_complete(inf, False, now, "LinkFailed")
                    i += 1
                else:
                    i = self._drain_failures(ops, i, now)
                continue
            if self._pending or \
                    inf.sl.hop + 1 < len(inf.tcb.plan.current.stages):
                self._on_wire_complete(inf, True, now, "")
                i += 1
                continue
            # scan the maximal vectorizable run. While no live batch carries
            # a done-callback (`_cb_batches == 0`) nothing mid-run can
            # submit new work, so the scan is a pure stage-shape check;
            # otherwise it also projects batch completions and cuts *after*
            # an item that completes a batch with registered callbacks (the
            # callback must observe the fully-drained per-item state exactly
            # like the scalar sequence exposes it)
            j = i
            hops: Dict[int, int] = {}  # route lengths memo (static mid-scan)
            run: List[_InflightSlice] = []
            if not self._cb_batches:
                while j < n:
                    op2 = ops[j]
                    if op2.failed:
                        break
                    inf2 = op2.tag
                    tcb2 = inf2.tcb
                    key = id(tcb2)
                    n_stages = hops.get(key)
                    if n_stages is None:
                        n_stages = hops[key] = len(tcb2.plan.current.stages)
                    if inf2.sl.hop + 1 < n_stages:
                        break
                    run.append(inf2)
                    j += 1
            else:
                rem: Dict[int, int] = {}
                while j < n:
                    op2 = ops[j]
                    if op2.failed:
                        break
                    inf2 = op2.tag
                    tcb2 = inf2.tcb
                    key = id(tcb2)
                    n_stages = hops.get(key)
                    if n_stages is None:
                        n_stages = hops[key] = len(tcb2.plan.current.stages)
                    if inf2.sl.hop + 1 < n_stages:
                        break
                    run.append(inf2)
                    bid = tcb2.batch_id
                    r = rem.get(bid)
                    if r is None:
                        r = batches[bid].remaining_slices
                    r -= 1
                    rem[bid] = r
                    j += 1
                    if r == 0 and batches[bid].callbacks:
                        break
            if j == i + 1:
                self._on_wire_complete(inf, True, now, "")
            else:
                self._drain_success_run(run, now)
            i = j
        if rec is not None:
            rec.end(t0, "drain_ns", "drain_n", 1)

    @hot_path

    def _drain_success_run(self, infs: List[_InflightSlice], now: float) -> None:
        """Vectorized drain of one run of successful final-hop completions.
        The telemetry columns were pre-packed per slice at post time
        (`_InflightSlice.drain`), so the gather is one zip. Order-equivalent
        to the per-item scalar sequence because, with the pending ring
        empty, each item's trailing `_dispatch` is a no-op, the EWMA/health
        updates of distinct items touch disjoint telemetry state (per-slot
        order is preserved inside `on_complete_many` / `observe_many`),
        remote discharges are pure per-link sums nothing reads mid-run, and
        `_finish_slice` reads none of it."""
        self._inflight -= len(infs)
        slots_c, len_c, queued_c, sched_c, pred_c, links_c, remote_c = zip(
            *(inf.drain for inf in infs))
        store = self.store
        discharges: Dict[int, int] = {}  # remote link -> summed lengths
        for rid, length in zip(remote_c, len_c):
            if rid >= 0:
                discharges[rid] = discharges.get(rid, 0) + length
        discharge = store.discharge_remote
        for rid, total in discharges.items():
            discharge(rid, total)
        slots = np.asarray(slots_c, dtype=np.int64)
        lengths = np.asarray(len_c, dtype=np.int64)
        queued_at = np.asarray(queued_c, dtype=np.int64)
        t_obs = now - np.asarray(sched_c, dtype=np.float64)
        jit = self._jit
        if jit is not None and len(slots) >= jit.min_batch:
            jit.on_complete_many(slots, lengths, queued_at, t_obs)
        else:
            store.on_complete_many(slots, lengths, queued_at, t_obs)
        t_pred = np.asarray(pred_c, dtype=np.float64)
        if self.health.observe_many(slots, links_c, t_obs, t_pred):
            self._arm_probe_timer()
        rec = self._rec
        if rec is not None:
            # one append for the whole drain run — the batched-drain analogue
            # of the scalar handler's single-slice COMPLETE
            rec.append(OBS.COMPLETE, now, {
                "engine": self.name,
                "slices": [inf.sl for inf in infs],
                "links": links_c,
                "scheduled": sched_c,
                "t_pred": pred_c,
                "lengths": len_c})
        # one shared finish body with the scalar drain — any future
        # completion side effect lands in both drains by construction
        finish = self._finish_slice
        for inf in infs:
            finish(inf.sl, inf.tcb, now)
        self._dispatch()

    @hot_path

    def _drain_failures(self, ops, i: int, now: float) -> int:
        """Batched retry/requeue handler: process the run of consecutive
        failed completions starting at `i` with exact per-item bookkeeping
        (cancel charges, dual-layer exclusion, retry selection), deferring
        every retry's fabric post into one `post_many` flush — no per-slice
        closures, no per-slice post overhead, one trailing redispatch.
        Returns the index after the last item processed (early when an app
        callback refilled the pending ring: the rest of the batch takes the
        scalar per-item path)."""
        n = len(ops)
        buffer: list = []
        self._post_buffer = buffer
        try:
            while i < n and ops[i].failed:
                self._on_wire_complete_nofanout(ops[i].tag, now)
                i += 1
                if self._pending:
                    break
        finally:
            self._post_buffer = None
        if buffer:
            self.fabric.post_many(buffer, self._on_wire_done, tenant=self.name)
        self._dispatch()
        return i

    def _on_wire_complete_nofanout(self, inf: _InflightSlice, now: float) -> None:
        """One failure item inside the batched drain: identical to the
        scalar `_on_wire_complete(ok=False)` minus the per-item dispatch
        (a no-op while the pending ring is empty, which `_drain_failures`
        guarantees)."""
        self._inflight -= 1
        if inf.path.remote is not None:
            self.store.discharge_remote(inf.path.remote.link_id, inf.sl.length)
        self._handle_wire_failure(inf, now)

    def _finish_slice(self, sl: Slice, tcb: _TransferCB, t_end: float) -> None:
        # Idempotent write to the absolute destination offset. For staged
        # routes the intermediate hops are timing-only; bytes land here. A
        # phantom destination's write is a no-op, so skip materializing the
        # source bytes at all (phantom reads allocate a zero buffer per
        # slice — pure drain-loop waste for timing-only segments); bounds
        # were validated for the whole transfer at submit time. The source
        # range is read in place, so a slice makes one host copy, the write;
        # overlapping ranges of one segment are read out first, since a
        # write across two buffers could overwrite source bytes it has yet
        # to copy.
        src_seg, dst_seg, dst_phantom = tcb.segs
        if not dst_phantom:
            src, dst, n = sl.src_offset, sl.dst_offset, sl.length
            if src_seg is dst_seg and src < dst + n and dst < src + n:
                dst_seg.write(dst, src_seg.read(src, n))
            else:
                dst_seg.write(dst, src_seg.read_in_place(src, n))
        sl.state = SliceState.DONE
        sl.completed_at = t_end
        tcb.remaining -= 1
        bc = self._batches[tcb.batch_id]
        bc.remaining_slices -= 1
        if bc.remaining_slices == 0 and bc.state == BatchState.SUBMITTED:
            self._complete_app_batch(bc, t_end)

    def _complete_app_batch(self, bc: _BatchCB, t_end: float) -> None:
        """Last slice of an application batch landed: surface the completion
        through the hierarchical counters and run the registered callbacks."""
        bc.state = BatchState.DONE
        bc.completed_at = t_end
        self._open_work -= 1
        if bc.callbacks:
            self._cb_batches -= 1
        rec = self._rec
        if rec is not None:
            rec.append(OBS.BATCH_DONE, t_end, {
                "engine": self.name, "batch": rec.bid(bc.batch_id),
                "bytes": bc.bytes_total})
        for cb in bc.callbacks:
            cb(bc)

    def _fail_batch(self, tcb: _TransferCB, code: str) -> None:
        # Inside the batched failure drain, deferred retry posts must reach
        # the fabric before any app callback runs (a callback may submit and
        # dispatch new work, and the scalar drain posted those retries
        # first); the buffer is disarmed around the callbacks so work they
        # trigger posts inline, exactly like the scalar sequence.
        buf = self._post_buffer
        if buf is not None:
            self._post_buffer = None
            if buf:
                self.fabric.post_many(
                    list(buf), self._on_wire_done, tenant=self.name)
                buf.clear()
        try:
            bc = self._batches[tcb.batch_id]
            if bc.state == BatchState.SUBMITTED:
                bc.state = BatchState.FAILED
                bc.error = code
                bc.completed_at = self.fabric.now
                rec = self._rec
                if rec is not None:
                    rec.append(OBS.BATCH_FAIL, bc.completed_at, {
                        "engine": self.name, "batch": rec.bid(bc.batch_id),
                        "error": code})
                self._open_work -= 1
                if bc.callbacks:
                    self._cb_batches -= 1
                for cb in bc.callbacks:
                    cb(bc)
        finally:
            if buf is not None:
                self._post_buffer = buf

    # ----------------------------------------------------------- timers
    def _arm_reset_timer(self) -> None:
        if self._reset_timer_armed or self.config.reset_interval <= 0:
            return
        self._reset_timer_armed = True
        self.fabric.call_after(self.config.reset_interval, self._on_reset_timer)

    def _on_reset_timer(self) -> None:
        self._reset_timer_armed = False
        # Periodic state reset (paper §4.2): forget learned penalties and
        # re-admit excluded rails so recovered paths rejoin the pool.
        for lid in self.health.excluded_links():
            self.health.readmit(lid)
        self.store.reset_all()
        if self._open_work > 0:
            self._arm_reset_timer()

    def _arm_probe_timer(self) -> None:
        if self._probe_timer_armed or self.config.health.probe_interval <= 0:
            return
        self._probe_timer_armed = True
        self.fabric.call_after(self.config.health.probe_interval, self._on_probe_timer)

    def _on_probe_timer(self) -> None:
        self._probe_timer_armed = False
        excluded = self.health.excluded_links()
        if not excluded:
            return
        for lid in excluded:
            self.fabric.post(
                lid, None, self.config.health.probe_bytes,
                lambda ok, t0, t1, err, l=lid: self._on_probe_done(l, ok),
            )
        if self._open_work > 0:
            self._arm_probe_timer()

    def _on_probe_done(self, link_id: int, ok: bool) -> None:
        if ok:
            self.health.readmit(link_id, verified=True)

    # ----------------------------------------------------------- metrics
    @property
    def open_batches(self) -> int:
        """Batches submitted but not yet completed/failed — the cluster
        control plane keeps its diffusion timer armed while any engine has
        open work."""
        return self._open_work

    def audit(self, *, ignore: Optional[Sequence[int]] = None) -> Dict[str, int]:
        """Batch/slice accounting across the engine's lifetime: every slice
        ever submitted must be either completed (its batch DONE) or surfaced
        as an application-visible batch failure — the zero-lost-slice
        invariant the scenario regression tier asserts. Batch ids in
        `ignore` (e.g. open-ended background tenant flows) are skipped."""
        skip = frozenset(ignore or ())
        out = {"batches_done": 0, "batches_failed": 0, "batches_open": 0,
               "slices_outstanding": 0}
        for bid, bc in self._batches.items():
            if bid in skip or bc.state == BatchState.OPEN:
                continue
            if bc.state == BatchState.DONE:
                out["batches_done"] += 1
            elif bc.state == BatchState.FAILED:
                out["batches_failed"] += 1
            else:
                out["batches_open"] += 1
                out["slices_outstanding"] += bc.remaining_slices
        return out

    def bytes_by_link(self) -> Dict[int, int]:
        return self.fabric.bytes_by_link()
