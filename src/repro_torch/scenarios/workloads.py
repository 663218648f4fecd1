"""Workload executors and background-contention generators.

Everything here drives a `TentEngine` on its virtual clock and reports a
uniform `WorkloadOutcome` (completion timeline + byte totals + audit), so the
`ScenarioRunner` can compute the same metrics for very different workloads.
`benchmarks/common.py` re-exports the generators so TEBench scripts and the
scenario matrix share one implementation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core import Location, MemoryKind, TentEngine
from .spec import (
    CheckpointWorkload,
    ClosedLoopWorkload,
    ClusterWorkload,
    FaultEvent,
    ServeWorkload,
    ServingWorkload,
    Workload,
)

EVENT_BUDGET = 60_000_000


@dataclasses.dataclass
class WorkloadOutcome:
    """What one policy-run of one workload produced, before metric reduction."""

    completions: List[Tuple[float, int, float]]  # (t_end, nbytes, latency)
    bytes_total: int
    makespan: float
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Segment placement helpers
# ---------------------------------------------------------------------------


def host_loc(node: int, numa: int = 0) -> Location:
    return Location(node=node, kind=MemoryKind.HOST_DRAM, device=numa, numa=numa)


def gpu_loc(engine: TentEngine, node: int, gpu: int) -> Location:
    spec = engine.topology.spec
    return Location(node=node, kind=MemoryKind.DEVICE_HBM, device=gpu,
                    numa=spec.node.gpu_numa(gpu))


def _cyc(t: Tuple[int, ...], i: int) -> int:
    return t[i % len(t)]


def _stream_endpoints(engine: TentEngine, wl: ClosedLoopWorkload, i: int):
    src_node, dst_node = _cyc(wl.src_nodes, i), _cyc(wl.dst_nodes, i)
    block = _cyc(wl.blocks, i)
    if wl.endpoints == "gpu":
        n_gpus = engine.topology.spec.node.n_gpus
        src = gpu_loc(engine, src_node, i % n_gpus)
        dst = gpu_loc(engine, dst_node, i % n_gpus)
    elif wl.endpoints == "host":
        src = host_loc(src_node, _cyc(wl.src_numa, i))
        dst = host_loc(dst_node, _cyc(wl.dst_numa, i))
    else:
        raise ValueError(f"unknown endpoints kind {wl.endpoints!r}")
    s = engine.register_segment(src, block, materialize=False)
    d = engine.register_segment(dst, block, materialize=False)
    return s, d, block


# ---------------------------------------------------------------------------
# Closed-loop (TEBench) executor
# ---------------------------------------------------------------------------


class StreamDriver:
    """The generalized TEBench submission loop on one (possibly shared)
    fabric: each stream is (owning engine, [(src_seg, dst_seg, nbytes), ...])
    and keeps exactly one batch of those transfers in flight, resubmitting on
    completion — `iters` times, or until `duration` on the virtual clock when
    set. Single-engine closed loops and multi-engine cluster workloads both
    reduce to this.

    Streams may be added while the loop is running (`add_stream` from a
    scheduled callback) — that is how an engine joining the cluster mid-run
    starts producing. The `alive` predicate is consulted before every
    (re)submission, so a departed engine's streams stop pumping the moment
    it leaves while its in-flight batches still drain and count.
    `hold_until` keeps the loop stepping through quiet gaps up to a known
    future event (e.g. a join scheduled after the current work drains)."""

    def __init__(
        self,
        fabric,
        *,
        iters: int,
        duration: float = 0.0,
        alive: Optional[Callable[[TentEngine], bool]] = None,
    ):
        self.fabric = fabric
        self.iters = iters
        self.timed = duration > 0
        self.alive = alive or (lambda engine: True)
        self.completions: List[Tuple[float, int, float]] = []
        self.bytes_total = 0
        self._pending: Set[int] = set()
        self._streams: List[Tuple[TentEngine, List[Tuple[int, int, int]]]] = []
        self._done: List[int] = []
        self._t_start = fabric.now
        self._deadline = self._t_start + duration  # relative to current clock
        self._hold = self._t_start

    def add_stream(
        self, engine: TentEngine, transfers: List[Tuple[int, int, int]]
    ) -> None:
        self._streams.append((engine, transfers))
        self._done.append(0)
        self._submit(len(self._streams) - 1)

    def hold_until(self, t: float) -> None:
        """Keep the loop alive at least to virtual time `t` (a scheduled
        churn event), even if all in-flight work drains first."""
        self._hold = max(self._hold, t)

    def _submit(self, i: int) -> None:
        if self.timed and self.fabric.now >= self._deadline:
            return
        eng, transfers = self._streams[i]
        if not self.alive(eng):
            return
        nbytes = sum(t[2] for t in transfers)
        b = eng.allocate_batch()
        t0 = self.fabric.now
        eng.submit_transfer(b, [(s, 0, d, 0, n) for (s, d, n) in transfers])
        self._pending.add(b)
        self.bytes_total += nbytes

        def on_done(res, i=i, b=b, t0=t0, nbytes=nbytes):
            self._pending.discard(b)
            self.completions.append(
                (self.fabric.now, nbytes, self.fabric.now - t0))
            self._done[i] += 1
            if self.timed or self._done[i] < self.iters:
                self._submit(i)

        eng.on_batch_done(b, on_done)

    def _active(self) -> bool:
        if self._pending or self.fabric.now < self._hold:
            return True
        if self.timed:
            return False
        return any(
            d < self.iters
            for (eng, _), d in zip(self._streams, self._done)
            if self.alive(eng)
        )

    def run(self) -> WorkloadOutcome:
        guard = 0
        while self._active():
            if not self.fabric.step():
                raise RuntimeError("fabric idle before workload completed")
            guard += 1
            if guard > EVENT_BUDGET:
                raise RuntimeError("workload event budget exceeded")
        return WorkloadOutcome(
            completions=self.completions,
            bytes_total=self.bytes_total,
            makespan=self.fabric.now - self._t_start,
        )


def drive_streams(
    fabric,
    streams: List[Tuple[TentEngine, List[Tuple[int, int, int]]]],
    *,
    iters: int,
    duration: float = 0.0,
) -> WorkloadOutcome:
    """Static-stream convenience wrapper over `StreamDriver`."""
    driver = StreamDriver(fabric, iters=iters, duration=duration)
    for eng, transfers in streams:
        driver.add_stream(eng, transfers)
    return driver.run()


def drive_closed_loop(
    engine: TentEngine,
    streams: List[Tuple[int, int, int]],  # (src_seg_id, dst_seg_id, block_bytes)
    *,
    iters: int,
    batch_size: int = 1,
    duration: float = 0.0,
) -> WorkloadOutcome:
    """The single-engine TEBench loop: each stream keeps one batch of
    `batch_size` identical transfers in flight. Shared by the scenario
    runner and benchmarks/common.py."""
    flat = [
        (engine, [(src, dst, block)] * batch_size) for (src, dst, block) in streams
    ]
    return drive_streams(engine.fabric, flat, iters=iters, duration=duration)


def run_closed_loop(engine: TentEngine, wl: ClosedLoopWorkload) -> WorkloadOutcome:
    streams = []
    for i in range(wl.streams):
        src, dst, block = _stream_endpoints(engine, wl, i)
        streams.append((src.segment_id, dst.segment_id, block))
    return drive_closed_loop(
        engine, streams, iters=wl.iters, batch_size=wl.batch_size,
        duration=wl.duration)


# ---------------------------------------------------------------------------
# HiCache serving executor
# ---------------------------------------------------------------------------


def run_serve(engine: TentEngine, wl: ServeWorkload) -> WorkloadOutcome:
    from ..configs import get_config
    from ..serving import (
        HiCache,
        ServeSimConfig,
        ServingSimulator,
        from_table2,
        kv_bytes_per_token,
        make_cpu_pool,
        make_disk_pool,
        make_gpu_pool,
    )

    cfg = get_config(wl.model)
    hc: Optional[HiCache] = None
    if wl.use_hicache:
        pb = kv_bytes_per_token(cfg) * wl.page_tokens
        turns_pages = wl.turns * wl.input_tokens // wl.page_tokens + 2
        hc = HiCache(
            engine, cfg,
            gpu_pool=make_gpu_pool(engine, wl.gpu_node, 0, page_bytes=pb,
                                   num_pages=3 * turns_pages, materialize=False),
            cpu_pool=make_cpu_pool(engine, wl.store_node, page_bytes=pb,
                                   num_pages=wl.clients * turns_pages + 8,
                                   materialize=False),
            disk_pool=make_disk_pool(engine, wl.store_node, page_bytes=pb,
                                     num_pages=wl.clients * turns_pages + 8,
                                     materialize=False),
            page_tokens=wl.page_tokens,
        )
    sim = ServingSimulator(
        engine, from_table2(), hicache=hc,
        sim_cfg=ServeSimConfig(
            clients=wl.clients, concurrency=wl.concurrency, turns=wl.turns,
            input_tokens=wl.input_tokens, output_tokens=wl.output_tokens,
        ),
    )
    t0 = engine.fabric.now
    st = sim.run()
    extra = {
        "input_throughput": st.input_throughput,
        "avg_ttft_s": st.avg_ttft,
        "p50_ttft_s": st.p50_ttft,
        "p90_ttft_s": st.p90_ttft,
        "p99_ttft_s": st.p99_ttft,
        "bytes_promoted": float(st.bytes_promoted),
    }
    for r, v in st.round_avg_ttft.items():
        extra[f"round_avg_ttft_R{r}"] = v
    return WorkloadOutcome(
        completions=list(st.request_log),
        bytes_total=st.bytes_promoted,
        makespan=engine.fabric.now - t0 if engine.fabric.now > t0 else st.makespan,
        extra=extra,
    )


# ---------------------------------------------------------------------------
# Closed-loop serving executor (event-driven, async transfer intents)
# ---------------------------------------------------------------------------


def run_serving(engine: TentEngine, wl: ServingWorkload) -> WorkloadOutcome:
    from ..configs import get_config
    from ..serving import (
        CheckpointEngine,
        HiCache,
        ServeSimConfig,
        ServingSimulator,
        from_table2,
        kv_bytes_per_token,
        make_cpu_pool,
        make_disk_pool,
        make_gpu_pool,
    )

    if wl.stream_requests > 0:
        return _run_serving_stream(engine, wl)

    cfg = get_config(wl.model)
    hc: Optional[HiCache] = None
    if wl.use_hicache:
        pb = kv_bytes_per_token(cfg) * wl.page_tokens
        turns_pages = wl.turns * wl.input_tokens // wl.page_tokens + 2
        hc = HiCache(
            engine, cfg,
            gpu_pool=make_gpu_pool(engine, wl.gpu_node, 0, page_bytes=pb,
                                   num_pages=3 * turns_pages, materialize=False),
            cpu_pool=make_cpu_pool(engine, wl.store_node, page_bytes=pb,
                                   num_pages=wl.clients * turns_pages + 8,
                                   materialize=False),
            disk_pool=make_disk_pool(engine, wl.store_node, page_bytes=pb,
                                     num_pages=wl.clients * turns_pages + 8,
                                     materialize=False),
            page_tokens=wl.page_tokens,
        )
    ckpt: Optional[CheckpointEngine] = None
    if wl.checkpoint_nbytes > 0 and wl.checkpoint_updates > 0:
        spec = engine.topology.spec
        ckpt = CheckpointEngine(
            engine, nodes=spec.n_nodes, gpus_per_node=min(spec.node.n_gpus, 4),
            source_node=wl.store_node, materialize=False)
        ckpt.register_checkpoint({"weights": wl.checkpoint_nbytes})
    sim = ServingSimulator(
        engine, from_table2(), hicache=hc, checkpoint=ckpt,
        sim_cfg=ServeSimConfig(
            clients=wl.clients, concurrency=wl.concurrency, turns=wl.turns,
            input_tokens=wl.input_tokens, output_tokens=wl.output_tokens,
            mode="async", chunk_tokens=wl.chunk_tokens,
            decode_chunk=wl.decode_chunk,
            handoff_bytes_per_token=(
                kv_bytes_per_token(cfg) if wl.pd_handoff else 0),
            gpu_node=wl.gpu_node, decode_node=wl.decode_node,
            checkpoint_updates=wl.checkpoint_updates,
        ),
    )
    t0 = engine.fabric.now
    st = sim.run()
    extra = {
        "input_throughput": st.input_throughput,
        "avg_ttft_s": st.avg_ttft,
        "p50_ttft_s": st.p50_ttft,
        "p90_ttft_s": st.p90_ttft,
        "p99_ttft_s": st.p99_ttft,
        "avg_tpot_s": st.avg_tpot,
        "p99_tpot_s": st.p99_tpot,
        "serialized_s": st.serialized_seconds,
        "overlap_ratio": (
            st.serialized_seconds / st.makespan if st.makespan > 0 else 0.0),
        "bytes_promoted": float(st.bytes_promoted),
        "bytes_handoff": float(st.bytes_handoff),
        "checkpoint_updates": float(st.checkpoint_updates),
        "checkpoint_seconds": st.checkpoint_seconds,
    }
    for r, v in st.round_avg_ttft.items():
        extra[f"round_avg_ttft_R{r}"] = v
    return WorkloadOutcome(
        completions=list(st.request_log),
        bytes_total=st.bytes_promoted + st.bytes_handoff,
        makespan=st.makespan,
        extra=extra,
    )


def _run_serving_stream(engine: TentEngine, wl: ServingWorkload) -> WorkloadOutcome:
    """Production-stream executor: the batched SoA stepper over a seeded
    Poisson/Zipf arrival stream (`ServingSimulator(mode="batched")`). No
    HiCache object at this scale — prefix caching is the vectorized
    group-residency model in `repro_torch.scenarios.traffic.promotion_bytes`."""
    from ..serving import ServeSimConfig, ServingSimulator, from_table2

    sim = ServingSimulator(
        engine, from_table2(), hicache=None,
        sim_cfg=ServeSimConfig(
            mode="batched",
            concurrency=wl.concurrency,
            input_tokens=wl.input_tokens,
            output_tokens=wl.output_tokens,
            chunk_tokens=wl.chunk_tokens,
            gpu_node=wl.gpu_node,
            store_node=wl.store_node,
            stream_requests=wl.stream_requests,
            arrival_rate=wl.arrival_rate,
            zipf_alpha=wl.zipf_alpha,
            traffic_groups=wl.traffic_groups,
            prefix_frac=wl.prefix_frac,
            stream_kv_bytes_per_token=wl.stream_kv_bytes_per_token,
            resident_s=wl.resident_s,
            tick_s=wl.tick_s,
        ),
    )
    st = sim.run()
    extra = {
        "input_throughput": st.input_throughput,
        "avg_ttft_s": st.avg_ttft,
        "p50_ttft_s": st.p50_ttft,
        "p90_ttft_s": st.p90_ttft,
        "p99_ttft_s": st.p99_ttft,
        "avg_tpot_s": st.avg_tpot,
        "p99_tpot_s": st.p99_tpot,
        "serialized_s": st.serialized_seconds,
        "overlap_ratio": (
            st.serialized_seconds / st.makespan if st.makespan > 0 else 0.0),
        "bytes_promoted": float(st.bytes_promoted),
        "requests_completed": float(st.requests),
    }
    return WorkloadOutcome(
        completions=list(st.request_log),
        bytes_total=st.bytes_promoted,
        makespan=st.makespan,
        extra=extra,
    )


# ---------------------------------------------------------------------------
# Checkpoint-broadcast executor
# ---------------------------------------------------------------------------


def run_checkpoint(engine: TentEngine, wl: CheckpointWorkload) -> WorkloadOutcome:
    from ..serving import CheckpointEngine

    ce = CheckpointEngine(
        engine, nodes=wl.nodes, gpus_per_node=wl.gpus_per_node,
        source_node=wl.source_node, materialize=False,
    )
    ce.register_checkpoint({"ckpt": wl.nbytes})
    t0 = engine.fabric.now
    res = ce.update()
    return WorkloadOutcome(
        completions=[(engine.fabric.now, res.bytes, res.seconds)],
        bytes_total=res.bytes,
        makespan=res.seconds,
        extra={
            "update_seconds": res.seconds,
            "aggregate_bandwidth": res.aggregate_bandwidth,
            "ranks": float(res.ranks),
        },
    )


def run_workload(engine: TentEngine, wl: Workload) -> WorkloadOutcome:
    if isinstance(wl, ClosedLoopWorkload):
        return run_closed_loop(engine, wl)
    if isinstance(wl, ServeWorkload):
        return run_serve(engine, wl)
    if isinstance(wl, ServingWorkload):
        return run_serving(engine, wl)
    if isinstance(wl, CheckpointWorkload):
        return run_checkpoint(engine, wl)
    if isinstance(wl, ClusterWorkload):
        raise TypeError(
            "ClusterWorkload needs a TentCluster; use run_cluster_workload "
            "(ScenarioRunner.run_policy dispatches there automatically)")
    raise TypeError(f"unknown workload {type(wl).__name__}")


# ---------------------------------------------------------------------------
# Multi-engine cluster executor
# ---------------------------------------------------------------------------


def _pump_cluster_contender(cluster, wl: ClusterWorkload, ignore: Dict[str, Set[int]]) -> None:
    """The cache-tier contender: open-ended elephant flows from the cache
    node(s) into the consumer pool, submitted through the contender's own
    engine (typically a statically ranked policy that pins a few receiver
    NICs). Batch ids are recorded so workload metrics and audits can separate
    this background pressure from the traffic under test."""
    eng = cluster.engines["cache"]
    rec = ignore.setdefault("cache", set())
    for cn in wl.contender_nodes:
        for s in range(wl.contender_streams):
            numa = s % 2
            src = eng.register_segment(
                host_loc(cn, numa), wl.contender_block, materialize=False)
            dst = eng.register_segment(
                host_loc(wl.consumer_nodes[s % len(wl.consumer_nodes)], numa),
                wl.contender_block, materialize=False)

            def pump(src=src, dst=dst):
                b = eng.allocate_batch()
                eng.submit_transfer(
                    b, [(src.segment_id, 0, dst.segment_id, 0, wl.contender_block)])
                rec.add(b)
                eng.on_batch_done(b, lambda res: pump())

            pump()


def _producer_streams(
    eng: TentEngine, wl: ClusterWorkload, node: int, phase: int
) -> List[List[Tuple[int, int, int]]]:
    """The `streams_per_engine` closed-loop KV streams one producer engine
    on `node` ships into the consumer pool (phase staggers the consumer
    round-robin so multiple producers spread across the pool)."""
    out = []
    for s in range(wl.streams_per_engine):
        numa = s % 2
        src = eng.register_segment(host_loc(node, numa), wl.block, materialize=False)
        cnode = wl.consumer_nodes[(phase + s) % len(wl.consumer_nodes)]
        dst = eng.register_segment(host_loc(cnode, numa), wl.block, materialize=False)
        out.append([(src.segment_id, dst.segment_id, wl.block)])
    return out


def _schedule_churn(
    cluster,
    driver: StreamDriver,
    wl: ClusterWorkload,
    churn: Sequence[FaultEvent],
    join_policy: str,
) -> None:
    """Install the fault program's join/leave events on the shared clock.
    A leaver is removed from the control plane (its streams stop at the next
    resubmission; in-flight batches drain and stay audited). A joiner is
    built cold and immediately starts producing into the consumer pool —
    the same declarative stream shape the original producers use."""
    for i, ev in enumerate(churn):
        driver.hold_until(ev.at)
        if ev.kind == "leave":
            cluster.fabric.call_at(
                ev.at, lambda name=ev.engine: cluster.remove_engine(name))
        else:  # join

            def _join(ev=ev, phase=i):
                eng = cluster.add_engine(ev.engine, (ev.node,), policy=join_policy)
                for transfers in _producer_streams(eng, wl, ev.node, phase):
                    driver.add_stream(eng, transfers)

            cluster.fabric.call_at(ev.at, _join)


def run_cluster_workload(
    cluster,
    wl: ClusterWorkload,
    churn: Sequence[FaultEvent] = (),
    *,
    join_policy: str = "tent",
) -> Tuple[WorkloadOutcome, Dict[str, Set[int]]]:
    """Drive a ClusterWorkload on a built `repro_torch.cluster.TentCluster`,
    optionally under membership churn (`churn`: the spec's join/leave
    events). Returns the outcome plus per-engine batch ids to exclude from
    audits (open-ended contender flows)."""
    ignore: Dict[str, Set[int]] = {}
    driver = StreamDriver(
        cluster.fabric, iters=wl.iters, duration=wl.duration,
        alive=lambda eng: eng.name not in cluster.departed)
    streams: List[Tuple[TentEngine, List[Tuple[int, int, int]]]] = []
    if wl.pattern == "kv_incast":
        # many prefill engines -> few decode nodes (receiver-side incast)
        for i, node in enumerate(wl.producer_nodes):
            eng = cluster.engines[f"prefill{node}"]
            for transfers in _producer_streams(eng, wl, node, i):
                streams.append((eng, transfers))
    else:  # ckpt_broadcast
        # trainer pushes one shard per consumer node in one declarative
        # batch, striping shard sources across its staging (producer) nodes
        tr = cluster.engines["trainer"]
        transfers = []
        for i, cnode in enumerate(wl.consumer_nodes):
            tnode = wl.producer_nodes[i % len(wl.producer_nodes)]
            src = tr.register_segment(
                host_loc(tnode, cnode % 2), wl.nbytes, materialize=False)
            dst = tr.register_segment(
                host_loc(cnode, cnode % 2), wl.nbytes, materialize=False)
            transfers.append((src.segment_id, dst.segment_id, wl.nbytes))
        streams.append((tr, transfers))
        # serving engines churn KV among themselves on the same rails
        for i, cnode in enumerate(wl.consumer_nodes):
            eng = cluster.engines[f"serving{cnode}"]
            nxt = wl.consumer_nodes[(i + 1) % len(wl.consumer_nodes)]
            for s in range(wl.streams_per_engine):
                numa = s % 2
                src = eng.register_segment(
                    host_loc(cnode, numa), wl.block, materialize=False)
                dst = eng.register_segment(
                    host_loc(nxt, numa), wl.block, materialize=False)
                streams.append((eng, [(src.segment_id, dst.segment_id, wl.block)]))
    if wl.contender_nodes:
        _pump_cluster_contender(cluster, wl, ignore)
    if churn:
        _schedule_churn(cluster, driver, wl, churn, join_policy)
    cluster.start()  # arm the diffusion timer now that work is in flight
    for eng, transfers in streams:
        driver.add_stream(eng, transfers)
    return driver.run(), ignore


# ---------------------------------------------------------------------------
# Background contention generators (shared with benchmarks/common.py)
# ---------------------------------------------------------------------------


def add_background_turbulence(engine: TentEngine, *, seed: int = 7,
                              horizon: float = 60.0, severity: float = 0.5) -> None:
    """Transient per-rail slowdowns (noisy neighbours / signal degradation,
    paper §2.2): deterministic schedule of degradation windows on RDMA rails."""
    rng = np.random.default_rng(seed)
    for node in range(engine.topology.spec.n_nodes):
        for nic in engine.topology.rdma_nics(node):
            # windows cover t=0 onward so short virtual-time experiments see
            # the same non-uniform fabric that long-running services do
            t = 0.0
            while t < horizon:
                dur = float(rng.uniform(0.05, 0.5))
                if rng.random() < 0.4:
                    factor = float(rng.uniform(1 - severity, 0.9))
                    engine.fabric.schedule_degradation(nic.link_id, at=t, until=t + dur, factor=factor)
                t += dur + float(rng.uniform(0.0, 0.3))


def add_tenant_contention(engine: TentEngine, *, streams: int = 4,
                          block: int = 64 << 20, horizon: float = 1e12,
                          record: Optional[Set[int]] = None) -> None:
    """Co-located tenants saturating the same rails (paper §2.2 "noisy
    neighbours"): closed-loop host-to-host elephant flows that run for the
    whole experiment, scheduled through the same engine/fabric. Batch ids are
    added to `record` so audits can separate tenant traffic from the workload
    under test."""
    for i in range(streams):
        numa = i % 2
        src = engine.register_segment(host_loc(0, numa), block, materialize=False)
        dst = engine.register_segment(host_loc(1, numa), block, materialize=False)

        def pump(src=src, dst=dst):
            if engine.fabric.now >= horizon:
                return
            b = engine.allocate_batch()
            engine.submit_transfer(b, [(src.segment_id, 0, dst.segment_id, 0, block)])
            if record is not None:
                record.add(b)
            engine.on_batch_done(b, lambda res: pump())

        pump()
