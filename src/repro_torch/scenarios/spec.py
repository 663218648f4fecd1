"""Declarative scenario specifications.

A `ScenarioSpec` is a pure-data description of one reproducible experiment:
a topology (`FabricSpec` parameters), a workload (closed-loop TEBench load,
HiCache serving turns, or a checkpoint broadcast), a fault program (failure
and degradation windows, flap storms, correlated multi-rail outages), the
background contention, the policy ablation list, and the invariants the run
is expected to uphold. The engine, the benchmarks, and the regression tests
all consume the same spec objects, so every claim in the paper is checked
against the same scenario matrix everywhere.

Specs are frozen dataclasses with a dict/JSON round-trip (`to_dict` /
`from_dict`, `to_json` / `from_json`): a scenario can live in code, in a
JSON file, or on a benchmark command line and mean exactly the same run.
"""
from __future__ import annotations

import dataclasses
import json
from typing import ClassVar, Dict, Tuple, Union

from ..core import EngineConfig, FabricSpec, HealthConfig, NodeSpec

# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologyParams:
    """The subset of `FabricSpec` a scenario varies, plus heterogeneity.

    `rail_bw_factors` models heterogeneous rails (mixed NIC generations,
    mis-negotiated links): each (nic_index, factor) entry derates that rail
    ordinal on *every* node for the whole run. It is applied as a silent
    fabric-level degradation, so the engine only learns it via telemetry —
    exactly the paper's hetero-bandwidth setting (§2.2).
    """

    n_nodes: int = 2
    n_numa: int = 2
    n_gpus: int = 8
    n_nics: int = 8
    nic_bw: float = 25.0e9
    # TCP fallback rail; scaled-down scenarios must derate it alongside
    # nic_bw or the engine simply routes the contention onto the 3 GB/s
    # default and the NIC numbers become decorative
    tcp_bw: float = 3.0e9
    has_nvlink: bool = True
    has_gpudirect: bool = True
    has_mnnvl: bool = False
    has_ub: bool = False
    rail_bw_factors: Tuple[Tuple[int, float], ...] = ()

    def to_fabric_spec(self) -> FabricSpec:
        return FabricSpec(
            n_nodes=self.n_nodes,
            node=NodeSpec(n_numa=self.n_numa, n_gpus=self.n_gpus, n_nics=self.n_nics),
            nic_bw=self.nic_bw,
            tcp_bw=self.tcp_bw,
            has_nvlink=self.has_nvlink,
            has_gpudirect=self.has_gpudirect,
            has_mnnvl=self.has_mnnvl,
            has_ub=self.has_ub,
        )

    @classmethod
    def from_dict(cls, d: dict) -> "TopologyParams":
        d = dict(d)
        d["rail_bw_factors"] = tuple(
            (int(i), float(f)) for i, f in d.get("rail_bw_factors", ())
        )
        return cls(**d)


# ---------------------------------------------------------------------------
# Fault program
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault-program event.

    kind "fail":    the rail (node, nic) flaps down over [at, until) —
                    in-flight slices abort (paper §2.3) and new posts error.
    kind "degrade": effective bandwidth of (node, nic) is multiplied by
                    `factor` over [at, until) — silent, only telemetry sees it.
    kind "join":    engine `engine` joins the cluster at `at`, owning `node`
                    (cluster workloads only) and starts producing.
    kind "leave":   engine `engine` departs the cluster at `at` (cluster
                    workloads only); its streams stop resubmitting, its
                    control-plane state is garbage-collected, and its
                    in-flight slices drain on the data plane.
    """

    kind: str  # "fail" | "degrade" | "join" | "leave"
    node: int
    nic: int
    at: float
    until: float = 0.0
    factor: float = 1.0
    engine: str = ""  # churn kinds: which engine joins/leaves

    def __post_init__(self) -> None:
        if self.kind not in ("fail", "degrade", "join", "leave"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in ("fail", "degrade") and self.until <= self.at:
            raise ValueError("fault window must have until > at")
        if self.kind in ("join", "leave") and not self.engine:
            raise ValueError(f"churn event {self.kind!r} needs an engine name")

    @property
    def is_churn(self) -> bool:
        return self.kind in ("join", "leave")

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(**d)


def engine_join(engine: str, node: int, *, at: float) -> FaultEvent:
    """Engine `engine` joins the cluster mid-run, owning `node`."""
    return FaultEvent("join", node, 0, at=at, engine=engine)


def engine_leave(engine: str, *, at: float) -> FaultEvent:
    """Engine `engine` departs the cluster mid-run."""
    return FaultEvent("leave", 0, 0, at=at, engine=engine)


def flap_storm(
    node: int, nic: int, *, start: float, flaps: int, down: float, up: float
) -> Tuple[FaultEvent, ...]:
    """Repeated short down/up cycles on one rail (the paper's link flaps)."""
    out = []
    t = start
    for _ in range(flaps):
        out.append(FaultEvent("fail", node, nic, at=t, until=t + down))
        t += down + up
    return tuple(out)


def rail_outage(
    node: int, nics: Tuple[int, ...], *, at: float, until: float
) -> Tuple[FaultEvent, ...]:
    """Correlated multi-rail outage (ToR/leaf failure takes several NICs)."""
    return tuple(FaultEvent("fail", node, n, at=at, until=until) for n in nics)


def degrade_ramp(
    node: int, nic: int, *, start: float, step: float, factors: Tuple[float, ...]
) -> Tuple[FaultEvent, ...]:
    """Stepwise degrade-then-recover ramp (e.g. 0.7 -> 0.4 -> 0.15 -> healthy)."""
    return tuple(
        FaultEvent("degrade", node, nic, at=start + i * step,
                   until=start + (i + 1) * step, factor=f)
        for i, f in enumerate(factors)
    )


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClosedLoopWorkload:
    """TEBench-style closed-loop load (paper §5.1.3): each stream keeps one
    batch of `batch_size` block transfers in flight, resubmitting on
    completion. Stream i draws its block size / endpoints cyclically from
    the tuples, so elephant+mice mixes and multi-node incast are just data.

    Either `iters` (each stream submits that many batches) or, when
    `duration` > 0, streams pump until the virtual clock passes `duration`.
    """

    kind: ClassVar[str] = "closed_loop"
    streams: int = 4
    blocks: Tuple[int, ...] = (16 << 20,)
    iters: int = 16
    batch_size: int = 1
    duration: float = 0.0
    endpoints: str = "host"  # "host" | "gpu"
    src_nodes: Tuple[int, ...] = (0,)
    dst_nodes: Tuple[int, ...] = (1,)
    src_numa: Tuple[int, ...] = (0, 1)
    dst_numa: Tuple[int, ...] = (0, 1)

    @classmethod
    def from_dict(cls, d: dict) -> "ClosedLoopWorkload":
        d = dict(d)
        for key in ("blocks", "src_nodes", "dst_nodes", "src_numa", "dst_numa"):
            if key in d:
                d[key] = tuple(int(v) for v in d[key])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ServeWorkload:
    """HiCache multi-turn serving (paper §5.1.1 / Table 2): conversations on
    `gpu_node`, the global KV pool's CPU/disk tiers on `store_node`; cached
    prefixes are promoted through the engine under test."""

    kind: ClassVar[str] = "serve"
    model: str = "qwen3-moe-235b-a22b"
    clients: int = 4
    concurrency: int = 2
    turns: int = 4
    input_tokens: int = 1024
    output_tokens: int = 32
    page_tokens: int = 256
    use_hicache: bool = True
    gpu_node: int = 0
    store_node: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "ServeWorkload":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ServingWorkload:
    """Event-driven serving closed loop on the wave engine (paper §5.1): each
    request's HiCache promotion, prefill->decode KV handoff, and decode are
    stages whose transfers are asynchronous TENT batches — concurrent
    requests genuinely overlap and contend on the fabric, chunked prefill
    interleaves with decode, and an optional checkpoint refresh runs
    overlapped with live traffic. TTFT/TPOT SLOs are declared in the spec's
    `Expectations` and evaluated by the runner."""

    kind: ClassVar[str] = "serving"
    model: str = "qwen3-moe-235b-a22b"
    clients: int = 6
    concurrency: int = 3
    turns: int = 3
    input_tokens: int = 1024
    output_tokens: int = 64
    page_tokens: int = 256
    chunk_tokens: int = 512  # prefill chunk; 0 = monolithic prefill
    decode_chunk: int = 16
    use_hicache: bool = True
    pd_handoff: bool = False  # ship prefill->decode KV through TENT
    checkpoint_nbytes: int = 0  # > 0: overlapped weight refresh of this size
    checkpoint_updates: int = 0
    gpu_node: int = 0
    store_node: int = 1
    decode_node: int = 1
    # --- production-stream fields (> 0 selects the batched SoA stepper) ---
    # total single-turn requests drawn from the seeded Poisson/Zipf stream
    # (repro_torch.scenarios.traffic); clients/turns/use_hicache are ignored —
    # prefix caching becomes the vectorized group-residency model
    stream_requests: int = 0
    arrival_rate: float = 0.0  # mean arrivals/s
    zipf_alpha: float = 1.1  # popularity skew over prefix groups
    traffic_groups: int = 64
    prefix_frac: float = 0.5  # cached-prefix share of each prompt
    # KV bytes promoted per cold prefix token; pins the wire-contention
    # level independently of the model's true KV width
    stream_kv_bytes_per_token: int = 1024
    resident_s: float = 1.0  # GPU residency window per prefix group
    tick_s: float = 0.005  # batched stepper's virtual-clock tick

    @classmethod
    def from_dict(cls, d: dict) -> "ServingWorkload":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class CheckpointWorkload:
    """Checkpoint-engine broadcast (paper §5.1.2 / Table 3): every rank pulls
    its weight shard from the parameter-server node in one declarative batch."""

    kind: ClassVar[str] = "checkpoint"
    nbytes: int = 1 << 30
    nodes: int = 2
    gpus_per_node: int = 8
    source_node: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "CheckpointWorkload":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ClusterWorkload:
    """Multi-engine cluster workload: a `repro_torch.cluster.TentCluster` of
    engines on one shared fabric/virtual clock, each owning a disjoint node
    subset (paper's one-engine-per-role deployment model).

    pattern "kv_incast":      one prefill engine per producer node ships KV
        closed-loop into the decode-pool engine owning `consumer_nodes`,
        while an optional cache-tier contender engine (whose static policy
        pins its elephants to a few receiver NICs) creates cross-engine
        pressure that siloed telemetry cannot see in advance.
    pattern "ckpt_broadcast": a trainer engine owning `producer_nodes`
        pushes one `nbytes` shard per consumer node in a single declarative
        batch per round, while per-node serving engines churn KV among
        themselves on the same rails.

    Policy names of the form "<base>+diffusion" in the spec's ablation list
    run with the cluster control plane enabled (global load table + failure
    rumors, `global_weight` as omega); plain names run the same engines as
    silos — that contrast is the paper's §4.2 headline experiment.
    """

    kind: ClassVar[str] = "cluster"
    pattern: str = "kv_incast"  # "kv_incast" | "ckpt_broadcast"
    producer_nodes: Tuple[int, ...] = (0, 1, 2)
    consumer_nodes: Tuple[int, ...] = (3,)
    contender_nodes: Tuple[int, ...] = ()  # () disables the cache-tier role
    streams_per_engine: int = 2
    block: int = 1 << 20
    iters: int = 8
    duration: float = 0.0
    contender_streams: int = 2
    contender_block: int = 16 << 20
    contender_policy: str = "static_best2"
    nbytes: int = 8 << 20  # ckpt_broadcast shard per consumer node
    # control-plane knobs (used only by "+diffusion" policies)
    diffusion_period: float = 0.001
    diffusion_staleness: float = 0.02
    gossip_delay: float = 0.0005
    global_weight: float = 0.6
    # control-plane link model (0/0/0 = idealized lossless broadcast):
    # per-message drop probability, per-message delivery delay (virtual s),
    # and fanout-k partial membership views (<=0 addresses every peer)
    gossip_loss: float = 0.0
    gossip_link_delay: float = 0.0
    fanout: int = 0

    def __post_init__(self) -> None:
        if self.pattern not in ("kv_incast", "ckpt_broadcast"):
            raise ValueError(f"unknown cluster pattern {self.pattern!r}")
        if not self.producer_nodes or not self.consumer_nodes:
            raise ValueError("cluster workload needs producers and consumers")
        if self.diffusion_period > 0 and self.diffusion_staleness < self.diffusion_period:
            # snapshots are delivered one period stale by construction, so a
            # staleness horizon below the period silently drops every entry
            raise ValueError(
                f"diffusion_staleness ({self.diffusion_staleness}) must be >= "
                f"diffusion_period ({self.diffusion_period})")
        if not 0.0 <= self.gossip_loss < 1.0:
            raise ValueError(f"gossip_loss must be in [0, 1), got {self.gossip_loss}")
        if self.gossip_link_delay < 0:
            raise ValueError(
                f"gossip_link_delay must be >= 0, got {self.gossip_link_delay}")
        if self.gossip_link_delay > 0 and self.diffusion_period > 0 and (
                self.gossip_link_delay + self.diffusion_period
                > self.diffusion_staleness):
            # a snapshot ages one period before it ships plus the link delay
            # in flight; past the horizon every delivery would arrive stale
            raise ValueError(
                f"gossip_link_delay ({self.gossip_link_delay}) + diffusion_period "
                f"({self.diffusion_period}) must be <= diffusion_staleness "
                f"({self.diffusion_staleness}) or every telemetry delivery "
                "arrives stale")

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterWorkload":
        d = dict(d)
        for key in ("producer_nodes", "consumer_nodes", "contender_nodes"):
            if key in d:
                d[key] = tuple(int(v) for v in d[key])
        return cls(**d)


Workload = Union[
    ClosedLoopWorkload, ServeWorkload, ServingWorkload, CheckpointWorkload,
    ClusterWorkload,
]

WORKLOAD_KINDS: Dict[str, type] = {
    w.kind: w
    for w in (ClosedLoopWorkload, ServeWorkload, ServingWorkload,
              CheckpointWorkload, ClusterWorkload)
}


# ---------------------------------------------------------------------------
# Background contention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BackgroundSpec:
    """Fabric-level noise the engine does not control: transient per-rail
    turbulence windows and co-located tenant elephant flows (paper §2.2)."""

    turbulence_severity: float = 0.0  # 0 disables
    turbulence_seed: int = 7
    turbulence_horizon: float = 60.0
    tenant_streams: int = 0
    tenant_block: int = 64 << 20

    @classmethod
    def from_dict(cls, d: dict) -> "BackgroundSpec":
        return cls(**d)


# ---------------------------------------------------------------------------
# Engine knobs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """The `EngineConfig`/`HealthConfig` knobs a scenario pins down. The
    policy itself comes from the spec's ablation list.

    `wave`/`candidate_cache` expose the engine's hot-path controls: both on
    (the default) runs the vectorized wave scheduler over cached per-stage
    candidate sets; both off reproduces the pre-wave one-slice-at-a-time
    loop with bit-identical scheduling decisions (the wave-parity regression
    and `benchmarks/spray_hotpath.py` rely on that toggle). `wave_complete`
    toggles the batched completion drain the same way (off = per-completion
    scalar drain, bit-identical outcomes), and `wave_min` pins the
    scalar/wave dispatch crossover instead of letting the engine tune it
    online."""

    slice_bytes: int = 64 * 1024
    max_slices: int = 64
    max_inflight: int = 256
    gamma: float = 0.05
    reset_interval: float = 1.0
    probe_interval: float = 0.02
    retry_limit: int = 8
    wave: bool = True
    candidate_cache: bool = True
    wave_complete: bool = True
    wave_min: Union[int, None] = None
    # selects the jitted fixed-shape chooser/drain kernels, as in the
    # reference package (specs round-trip with it); the port runs them as
    # CUDA kernels on the engine's device (see EngineConfig.jit_core)
    jit_core: bool = False
    # runs the fabric event loop on the calendar queue (bucketed timestamp
    # wheel) instead of the binary heap; bit-identical pop order, O(1)
    # amortized at serving-stream scale (see EngineConfig.calendar_queue)
    calendar_queue: bool = False

    def to_engine_config(self, policy: str) -> EngineConfig:
        return EngineConfig(
            policy=policy,
            slice_bytes=self.slice_bytes,
            max_slices=self.max_slices,
            max_inflight=self.max_inflight,
            gamma=self.gamma,
            reset_interval=self.reset_interval,
            wave=self.wave,
            candidate_cache=self.candidate_cache,
            wave_complete=self.wave_complete,
            wave_min=self.wave_min,
            jit_core=self.jit_core,
            calendar_queue=self.calendar_queue,
            health=HealthConfig(
                probe_interval=self.probe_interval, retry_limit=self.retry_limit
            ),
        )

    @classmethod
    def from_dict(cls, d: dict) -> "EngineParams":
        return cls(**d)


# ---------------------------------------------------------------------------
# Expectations (the regression tier's per-scenario invariants)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Expectations:
    """What must hold for the scenario to count as passing. A value of 0
    disables the corresponding check; `ScenarioReport.violations` lists every
    breach, so benchmarks and tests share one notion of "healthy"."""

    # primary policy throughput >= factor * every baseline's (0 disables)
    tent_vs_baseline: float = 1.0
    # worst throughput-dip duration after any "fail" onset, virtual ms
    max_recovery_ms: float = 0.0
    # worst time-to-next-completion after any "fail" onset, virtual ms
    max_stall_ms: float = 0.0
    # max/mean byte ratio across the busiest node's RDMA rails (primary policy)
    max_rail_imbalance: float = 0.0
    # primary P99 latency <= factor * every baseline's P99 (0 disables)
    p99_vs_baseline: float = 0.0
    # primary P50 latency <= factor * every baseline's P50 (0 disables);
    # mice-dominated mixes use this to pin down head-of-line isolation
    p50_vs_baseline: float = 0.0
    # serving SLOs (serving workloads; evaluated against the primary policy's
    # reported extra["p90_ttft_s"] / extra["p99_ttft_s"] / extra["p99_tpot_s"])
    # primary TTFT P90 <= factor * every baseline's TTFT P90 (0 disables)
    ttft_p90_vs_baseline: float = 0.0
    # absolute virtual-seconds ceilings on the primary policy (0 disables)
    max_ttft_p99_s: float = 0.0
    max_tpot_p99_s: float = 0.0
    # no app-visible failures and no slice unaccounted for, any policy
    zero_lost_slices: bool = True
    # Monte Carlo sweep expectations (evaluated by the reference package's
    # seed sweep, not ported yet, over the seed distribution; never by the
    # single-seed runner):
    # primary healing-time P99.9 ceiling across seeds, virtual ms (0 disables)
    healing_p999_ms: float = 0.0
    # primary throughput P50 >= factor * every baseline's P50 (0 disables)
    throughput_p50_vs_baseline: float = 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "Expectations":
        return cls(**d)


# ---------------------------------------------------------------------------
# The scenario itself
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    name: str
    description: str = ""
    topology: TopologyParams = dataclasses.field(default_factory=TopologyParams)
    workload: Workload = dataclasses.field(default_factory=ClosedLoopWorkload)
    faults: Tuple[FaultEvent, ...] = ()
    background: BackgroundSpec = dataclasses.field(default_factory=BackgroundSpec)
    policies: Tuple[str, ...] = ("tent", "round_robin")
    engine: EngineParams = dataclasses.field(default_factory=EngineParams)
    expectations: Expectations = dataclasses.field(default_factory=Expectations)
    seed: int = 0
    bucket: float = 0.005  # throughput-timeline bucket width (virtual s)

    @property
    def primary_policy(self) -> str:
        return self.policies[0]

    @property
    def baseline_policies(self) -> Tuple[str, ...]:
        return self.policies[1:]

    # -- round trip ----------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["workload"] = {"kind": self.workload.kind, **d["workload"]}
        return _jsonable(d)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        d = dict(d)
        wl = dict(d["workload"])
        wl_cls = WORKLOAD_KINDS[wl.pop("kind")]
        return cls(
            name=d["name"],
            description=d.get("description", ""),
            topology=TopologyParams.from_dict(d.get("topology", {})),
            workload=wl_cls.from_dict(wl),
            faults=tuple(FaultEvent.from_dict(f) for f in d.get("faults", ())),
            background=BackgroundSpec.from_dict(d.get("background", {})),
            policies=tuple(d.get("policies", ("tent", "round_robin"))),
            engine=EngineParams.from_dict(d.get("engine", {})),
            expectations=Expectations.from_dict(d.get("expectations", {})),
            seed=int(d.get("seed", 0)),
            bucket=float(d.get("bucket", 0.005)),
        )

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(s))


def _jsonable(obj):
    """Tuples -> lists, recursively, so to_dict() output is json.dumps-ready
    and equals json.loads(to_json()) exactly (round-trip tests rely on it)."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj
