"""The named scenario library: the regression matrix every PR runs against.

Each entry is a small, fully deterministic instance of one hostile condition
from the paper (§2.2-§2.3, §5): link flaps, flap storms, correlated outages,
NUMA-skewed incast, heterogeneous rails, tenant contention, elephant+mice
mixes, silent degradation ramps, disaggregated prefill/decode KV shipping,
HiCache serving, and checkpoint broadcast. Sizes are scaled down (slower
virtual NICs, MB-scale blocks) so the whole matrix runs in seconds of wall
clock — the asserted quantities (policy ordering, recovery time on the
virtual clock, slice accounting, byte balance) are scale-invariant, the same
trick benchmarks/table3 uses.

Benchmarks needing full-scale variants `dataclasses.replace(...)` these specs
rather than redefining them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from .spec import (
    BackgroundSpec,
    CheckpointWorkload,
    ClosedLoopWorkload,
    ClusterWorkload,
    EngineParams,
    Expectations,
    FaultEvent,
    ScenarioSpec,
    ServeWorkload,
    ServingWorkload,
    TopologyParams,
    degrade_ramp,
    engine_join,
    engine_leave,
    flap_storm,
    rail_outage,
)

# A slowed-down 2-node fabric for timeline (recovery) scenarios: completion
# density per bucket stays high while the event count stays small.
_SLOW = TopologyParams(nic_bw=1e9)
_PUMP = ClosedLoopWorkload(streams=4, blocks=(1 << 20,), iters=0, duration=0.08)


def _timeline(name: str, description: str, **kw) -> ScenarioSpec:
    kw.setdefault("topology", _SLOW)
    kw.setdefault("workload", _PUMP)
    kw.setdefault("bucket", 0.004)
    return ScenarioSpec(name=name, description=description, **kw)


SCENARIOS: Dict[str, ScenarioSpec] = {}


def _register(spec: ScenarioSpec) -> ScenarioSpec:
    assert spec.name not in SCENARIOS, f"duplicate scenario {spec.name}"
    SCENARIOS[spec.name] = spec
    return spec


_register(_timeline(
    "single_rail_flap",
    "One NIC flaps down mid-run and recovers (paper Fig. 10): the engine "
    "must mask the failure, run degraded, and reintegrate the rail.",
    faults=(FaultEvent("fail", 0, 0, at=0.025, until=0.06),),
    expectations=Expectations(
        tent_vs_baseline=1.0, max_recovery_ms=50.0, max_stall_ms=50.0,
        # Monte-Carlo tails (benchmarks/mc_sweep.py, 64+ seeds, jittered
        # onsets): measured healing P99.9 ~0.26ms, tent/rr P50 ratio ~1.18.
        healing_p999_ms=50.0, throughput_p50_vs_baseline=1.05),
))

_register(_timeline(
    "flap_storm",
    "Repeated short down/up cycles on one rail (paper §2.3 link flaps): "
    "every onset must be absorbed without app-visible failures.",
    workload=ClosedLoopWorkload(streams=4, blocks=(1 << 20,), iters=0, duration=0.1),
    faults=flap_storm(0, 0, start=0.02, flaps=3, down=0.008, up=0.012),
    expectations=Expectations(
        tent_vs_baseline=1.0, max_recovery_ms=50.0, max_stall_ms=50.0,
        # MC tails: measured healing P99.9 ~0.46ms, tent/rr P50 ratio ~1.17.
        healing_p999_ms=50.0, throughput_p50_vs_baseline=1.05),
))

_register(_timeline(
    "correlated_outage",
    "A ToR/leaf failure takes 5 of 8 rails at once: capacity halves, so the "
    "dip metric is moot — the engine must keep completing work (stall "
    "bounded) and lose nothing.",
    workload=ClosedLoopWorkload(streams=4, blocks=(1 << 20,), iters=0, duration=0.12),
    faults=rail_outage(0, (0, 1, 2, 3, 4), at=0.03, until=0.08),
    expectations=Expectations(tent_vs_baseline=1.0, max_stall_ms=50.0),
))

_register(ScenarioSpec(
    "numa_skew_incast",
    "Two sender nodes converge on one receiver node, all buffers pinned to "
    "NUMA0 (paper §2.2 skewed submission): receiver-side serialization plus "
    "cross-NUMA penalties.",
    topology=TopologyParams(n_nodes=3),
    workload=ClosedLoopWorkload(
        streams=4, blocks=(8 << 20,), iters=10,
        src_nodes=(0, 1), dst_nodes=(2,), src_numa=(0,), dst_numa=(0,)),
    expectations=Expectations(tent_vs_baseline=0.95),
))

_register(ScenarioSpec(
    "hetero_bandwidth_rails",
    "Half the rails run at 35% bandwidth (mixed NIC generations, paper "
    "§2.2): state-blind striping is dragged by the stragglers; telemetry "
    "must discover the asymmetry silently.",
    topology=TopologyParams(
        rail_bw_factors=((4, 0.35), (5, 0.35), (6, 0.35), (7, 0.35))),
    workload=ClosedLoopWorkload(streams=4, blocks=(8 << 20,), iters=12),
    expectations=Expectations(tent_vs_baseline=1.05),
))

_register(ScenarioSpec(
    "multi_tenant_contention",
    "KV shipping between GPUs while co-located tenants run elephant flows "
    "and the fabric sees turbulence windows (paper §2.2 noisy neighbours).",
    workload=ClosedLoopWorkload(
        streams=4, blocks=(8 << 20,), iters=10, endpoints="gpu"),
    background=BackgroundSpec(
        turbulence_severity=0.5, tenant_streams=2, tenant_block=32 << 20),
    expectations=Expectations(tent_vs_baseline=1.0),
))

_register(ScenarioSpec(
    "elephant_mice_mix",
    "One elephant stream and three mice streams share the rails: against a "
    "statically ranked engine (NIXL-style best-K) the mice are stuck behind "
    "elephant slices on the 'best' rail, so their P50 explodes; spraying "
    "must keep mice latency flat while moving more total bytes.",
    workload=ClosedLoopWorkload(
        streams=4, blocks=(64 << 20, 1 << 20, 1 << 20, 1 << 20), iters=10),
    policies=("tent", "static_best2"),
    expectations=Expectations(
        tent_vs_baseline=1.5, p99_vs_baseline=1.05, p50_vs_baseline=0.5),
))

_register(_timeline(
    "degrade_recover_ramp",
    "Two rails silently degrade in steps (0.7 -> 0.4 -> 0.15) then recover "
    "(paper §2.2 signal degradation): only telemetry can see it; the "
    "periodic reset must re-integrate the recovered rails.",
    workload=ClosedLoopWorkload(streams=4, blocks=(1 << 20,), iters=0, duration=0.1),
    faults=(degrade_ramp(0, 0, start=0.01, step=0.02, factors=(0.7, 0.4, 0.15))
            + degrade_ramp(0, 1, start=0.01, step=0.02, factors=(0.7, 0.4, 0.15))),
    expectations=Expectations(tent_vs_baseline=1.0),
))

_register(_timeline(
    "disagg_prefill_decode",
    "Dual-node disaggregated serving: prefill GPUs on node 0 ship KV to "
    "decode GPUs on node 1 (GPUDirect elephant flows) while a tier-1 NIC "
    "flaps — the decode side must never observe the fault.",
    workload=ClosedLoopWorkload(
        streams=4, blocks=(1 << 20,), iters=0, duration=0.08, endpoints="gpu"),
    faults=(FaultEvent("fail", 0, 1, at=0.02, until=0.05),),
    expectations=Expectations(
        tent_vs_baseline=1.0, max_recovery_ms=50.0, max_stall_ms=50.0),
))

_register(ScenarioSpec(
    "hicache_serve",
    "Multi-turn HiCache serving (Table 2 at regression scale): cached-prefix "
    "promotions from the global store node ride a slow turbulent fabric; the "
    "transfer policy is the only difference between runs.",
    topology=TopologyParams(nic_bw=2.5e9),
    workload=ServeWorkload(),
    background=BackgroundSpec(turbulence_severity=0.7),
    expectations=Expectations(tent_vs_baseline=1.0),
))

_register(ScenarioSpec(
    "checkpoint_broadcast",
    "RL weight refresh (Table 3 at regression scale): 16 ranks pull their "
    "shards from the parameter server through a turbulent fabric.",
    workload=CheckpointWorkload(nbytes=512 << 20),
    background=BackgroundSpec(turbulence_severity=0.6),
    expectations=Expectations(tent_vs_baseline=1.0),
))

# -- serving closed loop (event-driven, async transfer intents) --------------

_register(ScenarioSpec(
    "serving_closed_loop_flap",
    "HiCache serving as an event-driven closed loop under a flapping store-"
    "side NIC: concurrent requests' promotions overlap and contend on the "
    "fabric while one rail repeatedly browns out to 5% bandwidth. The "
    "engine's telemetry must route promotions around the flapping rail so "
    "TTFT P90 and the SLOs hold where blind striping is dragged down.",
    topology=TopologyParams(nic_bw=5e8),
    workload=ServingWorkload(clients=6, concurrency=3, turns=3,
                             output_tokens=8),
    # a flap expressed as repeated deep brownouts (degrade, not fail: the
    # serving timeline is too sparse for the stall/dip recovery metrics)
    faults=(FaultEvent("degrade", 1, 0, at=0.2, until=1.2, factor=0.05),
            FaultEvent("degrade", 1, 0, at=1.6, until=2.6, factor=0.05),
            FaultEvent("degrade", 1, 1, at=0.8, until=2.0, factor=0.05)),
    background=BackgroundSpec(turbulence_severity=0.7),
    expectations=Expectations(
        tent_vs_baseline=1.0, ttft_p90_vs_baseline=1.0,
        max_ttft_p99_s=1.5, max_tpot_p99_s=0.1),
))

_register(ScenarioSpec(
    "serving_pd_handoff_incast",
    "Prefill->decode disaggregation as async transfer intents: every "
    "request's KV pages ship from the prefill node to the decode node the "
    "moment its chunked prefill ends, so concurrent handoffs form a "
    "receiver-side incast on the decode node's rails while decode compute "
    "proceeds on already-landed caches.",
    topology=TopologyParams(
        nic_bw=5e8,
        rail_bw_factors=((4, 0.3), (5, 0.3), (6, 0.3), (7, 0.3))),
    workload=ServingWorkload(clients=6, concurrency=4, turns=2,
                             use_hicache=False, pd_handoff=True,
                             output_tokens=8),
    background=BackgroundSpec(turbulence_severity=0.6),
    expectations=Expectations(
        tent_vs_baseline=1.0, ttft_p90_vs_baseline=1.0,
        max_ttft_p99_s=2.5),
))

_register(ScenarioSpec(
    "serving_checkpoint_overlap",
    "Checkpoint-update-during-decode: an overlapped CheckpointEngine weight "
    "refresh (async all-rank pull) contends with live HiCache promotions "
    "mid-run. The refresh must not blow the serving SLOs, and the spraying "
    "engine must keep both flows moving where static striping serializes "
    "them behind the same rails.",
    topology=TopologyParams(nic_bw=5e8),
    workload=ServingWorkload(clients=6, concurrency=3, turns=3,
                             output_tokens=8,
                             checkpoint_nbytes=256 << 20,
                             checkpoint_updates=2),
    background=BackgroundSpec(turbulence_severity=0.6),
    expectations=Expectations(
        tent_vs_baseline=1.0, ttft_p90_vs_baseline=1.0,
        max_ttft_p99_s=1.5, max_tpot_p99_s=0.1),
))

_register(ScenarioSpec(
    "serving_production_stream",
    "Production-scale serving stream: 10^5 single-turn requests drawn from "
    "a seeded Poisson/Zipf mix hit the batched SoA stepper, with each cold "
    "prefix group's KV promoted store->GPU as one per-tick cohort batch. "
    "The byte demand runs ~1.1x the degraded fabric's cross-node capacity, "
    "so the stream is transfer-bound: the spray policy's effective "
    "bandwidth — not the compute model — sets the drain rate, TTFT tails, "
    "and makespan. Four silently derated rails (mixed NIC generations) "
    "plus brownout windows mid-run are where blind striping loses its "
    "capacity margin.",
    topology=TopologyParams(
        nic_bw=2.5e7, tcp_bw=2.5e7,
        rail_bw_factors=((4, 0.3), (5, 0.3), (6, 0.3), (7, 0.3))),
    workload=ServingWorkload(
        concurrency=512, input_tokens=128, output_tokens=16,
        chunk_tokens=256, stream_requests=100_000, arrival_rate=300.0,
        zipf_alpha=1.1, traffic_groups=512, prefix_frac=0.9375,
        stream_kv_bytes_per_token=40_000, resident_s=2.0, tick_s=0.04),
    engine=EngineParams(slice_bytes=4 << 20, max_slices=16,
                        reset_interval=30.0),
    faults=(FaultEvent("degrade", 1, 0, at=80.0, until=140.0, factor=0.1),
            FaultEvent("degrade", 1, 1, at=180.0, until=240.0, factor=0.1)),
    # measured (seeded, deterministic): tent 15947 tok/s vs rr 4098 (3.9x),
    # TTFT P90 18.1s vs 47.0s, P99 36.8s, TPOT P99 0.025s
    expectations=Expectations(
        tent_vs_baseline=2.0, ttft_p90_vs_baseline=1.0,
        max_ttft_p99_s=60.0, max_tpot_p99_s=0.05),
))

# -- hetero-fabric portability (Table 4 beyond RDMA/TCP) ---------------------

_register(ScenarioSpec(
    "mnnvl_rack_kv",
    "Rack-scale Multi-Node NVLink: cross-node GPU-to-GPU KV rides the MNNVL "
    "backend (956 GB/s, no host path) with multi-rail RDMA as the ranked "
    "fallback — the portability matrix beyond RDMA/TCP (Table 4).",
    topology=TopologyParams(nic_bw=2.5e9, has_mnnvl=True),
    workload=ClosedLoopWorkload(
        streams=4, blocks=(4 << 20,), iters=8, endpoints="gpu"),
    expectations=Expectations(tent_vs_baseline=0.95),
))

_register(ScenarioSpec(
    "ascend_ub_kv",
    "Ascend unified-bus fabric (no NVLink): cross-node GPU KV rides the UB "
    "backend; the same declarative transfers, a different interconnect — "
    "the paper's <800-LOC-per-backend portability claim (Table 4).",
    topology=TopologyParams(nic_bw=2.5e9, has_nvlink=False, has_ub=True),
    workload=ClosedLoopWorkload(
        streams=4, blocks=(4 << 20,), iters=8, endpoints="gpu"),
    expectations=Expectations(tent_vs_baseline=0.95),
))

# -- multi-engine cluster scenarios (repro_torch.cluster control plane) ------------

# 5-node incast fabric: 3 prefill nodes, 1 decode node, 1 cache-tier node.
_INCAST = ClusterWorkload(
    pattern="kv_incast", producer_nodes=(0, 1, 2), consumer_nodes=(3,),
    contender_nodes=(4,), streams_per_engine=2, block=1 << 20,
    iters=0, duration=0.04)

_register(ScenarioSpec(
    "multi_engine_kv_incast",
    "Three prefill engines converge KV on one decode pool while a cache-tier "
    "engine's statically ranked elephants pin two receiver NICs. The "
    "receiver-side pressure is invisible to siloed per-engine telemetry "
    "until slices are already stuck behind it; only the global diffusion "
    "table (omega blend, paper §4.2) steers the spray off the contended "
    "ordinals in advance — diffusion-ON tent must beat diffusion-OFF tent, "
    "not just the baselines.",
    topology=TopologyParams(n_nodes=5, nic_bw=1.0e9),
    workload=_INCAST,
    policies=("tent+diffusion", "tent", "round_robin"),
    expectations=Expectations(tent_vs_baseline=1.15),
    bucket=0.004,
))

_register(ScenarioSpec(
    "multi_engine_incast_flap",
    "Same cross-engine incast, plus a decode-side NIC flap: the first "
    "engine to observe the failure gossips it, so every other engine "
    "reroutes before paying the detection latency itself — cluster-wide "
    "self-healing within the virtual 50 ms budget (paper §4.3 at cluster "
    "scope).",
    topology=TopologyParams(n_nodes=5, nic_bw=1.0e9),
    workload=dataclasses.replace(_INCAST, duration=0.06),
    faults=(FaultEvent("fail", 3, 2, at=0.02, until=0.04),),
    policies=("tent+diffusion", "tent", "round_robin"),
    # the dip metric needs a dense pre-onset completion timeline, which an
    # incast-contended closed loop does not have; time-to-next-completion
    # (stall) is the meaningful cluster recovery bound here
    expectations=Expectations(tent_vs_baseline=1.1, max_stall_ms=50.0),
    bucket=0.004,
))

_register(ScenarioSpec(
    "lossy_gossip_flap",
    "The incast flap rerun with the control-plane crutch removed: every "
    "gossip message (telemetry snapshot, failure rumor, anti-entropy "
    "digest) rides a channel that drops 20% of them and delays the rest by "
    "5 ms virtual. Rumors get lost, telemetry rounds arrive stale — yet "
    "versioned records plus anti-entropy reconciliation must still heal the "
    "explicit wire failure cluster-wide inside the paper's 50 ms budget.",
    topology=TopologyParams(n_nodes=5, nic_bw=1.0e9),
    workload=dataclasses.replace(
        _INCAST, duration=0.06, gossip_loss=0.2, gossip_link_delay=0.005),
    faults=(FaultEvent("fail", 3, 2, at=0.02, until=0.04),),
    policies=("tent+diffusion", "tent", "round_robin"),
    expectations=Expectations(tent_vs_baseline=1.1, max_stall_ms=50.0),
    bucket=0.004,
))

_register(ScenarioSpec(
    "partial_view_incast",
    "The cross-engine incast with partial membership views: each gossip "
    "send addresses only a fanout-2 peer sample instead of the full roster, "
    "so no engine ever holds an instantaneous global load picture. Entries "
    "accumulate across rounds inside the staleness horizon and anti-entropy "
    "fills the rumor gaps — diffusion must still pay for itself against the "
    "siloed baseline.",
    topology=TopologyParams(n_nodes=5, nic_bw=1.0e9),
    workload=dataclasses.replace(_INCAST, fanout=2),
    policies=("tent+diffusion", "tent", "round_robin"),
    expectations=Expectations(tent_vs_baseline=1.10),
    bucket=0.004,
))

_register(ScenarioSpec(
    "engine_churn_diffusion",
    "Membership churn mid-incast: one prefill engine deregisters at 15 ms "
    "(its control-plane state must be garbage-collected — no ghost pressure "
    "from its final published footprint) and a cold engine joins at 20 ms "
    "on a fresh node, learning the cluster's load and open rumors only "
    "through diffusion and anti-entropy. The control plane must keep "
    "beating the siloed baseline >= 1.10x straight through both events.",
    topology=TopologyParams(n_nodes=6, nic_bw=1.0e9),
    workload=dataclasses.replace(_INCAST, duration=0.05),
    faults=(engine_leave("prefill2", at=0.015),
            engine_join("prefill5", 5, at=0.02)),
    policies=("tent+diffusion", "tent", "round_robin"),
    expectations=Expectations(tent_vs_baseline=1.10),
    bucket=0.004,
))

_register(ScenarioSpec(
    "churn_storm",
    "Membership churn in bursts, not single events: two prefill engines "
    "deregister back-to-back mid-incast, two cold engines join moments "
    "later, one of the joiners leaves again, and a decode-side NIC flaps "
    "while the roster is still settling. Every departure must be garbage-"
    "collected without ghost pressure, every joiner must bootstrap from "
    "gossip alone, no slice may be lost on any engine (including the ones "
    "that left with slices in flight), and the wire failure must still "
    "heal inside the 50 ms virtual budget through all of it.",
    topology=TopologyParams(n_nodes=8, nic_bw=1.0e9),
    workload=dataclasses.replace(_INCAST, duration=0.05),
    faults=(
        engine_leave("prefill1", at=0.010),
        engine_leave("prefill2", at=0.012),
        engine_join("prefill5", 5, at=0.014),
        engine_join("prefill6", 6, at=0.016),
        FaultEvent("fail", 3, 1, at=0.020, until=0.035),
        engine_leave("prefill5", at=0.025),
        engine_join("prefill7", 7, at=0.030),
    ),
    policies=("tent+diffusion", "tent", "round_robin"),
    expectations=Expectations(tent_vs_baseline=1.0, max_stall_ms=50.0),
    bucket=0.004,
))

_register(ScenarioSpec(
    "trainer_broadcast_fanout",
    "A trainer engine fans checkpoint shards out to three serving engines "
    "that are churning KV among themselves, while a cache-tier engine's "
    "statically pinned refill elephants sit on some of the serving nodes' "
    "receiver NICs: the diffusion table lets the trainer route its "
    "broadcast around queues it has never sent a byte into.",
    topology=TopologyParams(n_nodes=5, nic_bw=1.0e9),
    workload=ClusterWorkload(
        pattern="ckpt_broadcast", producer_nodes=(0,), consumer_nodes=(1, 2, 3),
        contender_nodes=(4,), streams_per_engine=1, block=1 << 20,
        nbytes=8 << 20, iters=6),
    policies=("tent+diffusion", "tent", "round_robin"),
    expectations=Expectations(tent_vs_baseline=1.15),
))

_register(ScenarioSpec(
    "uniform_spray",
    "Healthy symmetric fabric, host-to-host elephants: the null case. The "
    "spray must stay balanced across rails and telemetry overhead must not "
    "cost throughput against blind striping.",
    workload=ClosedLoopWorkload(streams=4, blocks=(8 << 20,), iters=12),
    expectations=Expectations(tent_vs_baseline=0.9, max_rail_imbalance=1.35),
))


def names() -> List[str]:
    return sorted(SCENARIOS)


def get(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; have {names()}") from None
