"""Monte Carlo fault sweeps: distributions over a `ScenarioSpec`, one seed lane each.

`compile_spray_program` lowers a closed-loop scenario into the fixed-shape
`SprayProgram` the fused spray sim consumes (repro_torch.core.jit_core): it builds
the scenario's engine exactly as `ScenarioRunner` would — same topology, same
heterogeneity derating, same fault program, same turbulence — probes one
representative transfer to resolve the plan's stage-0 candidate rails, and
snapshots the fabric's installed fault/degradation schedule into dense
per-rail window arrays. `MonteCarloSweep` then runs that program over N seed
lanes (one `spray_sim` launch, a lane a thread, on the card; the plain torch
sim on the CPU) with per-seed jittered fault parameters (flap
onset/duration, degrade depth/timing) and reports healing-time and
throughput *distributions* — P50/P99/P99.9 with bootstrap confidence
intervals — as a `SweepReport`, whose `to_scenario_report` is the
`tent-scenario-reports/v1` shape of the reference's `BENCH_mc.json`.

The compiled model is the *skeleton* of the engine, not the engine: one plan
stage (the probe transfer's hop 0), uniform slice length, one masked retry
per slice, round-granular clock advancement. That is the deliberate trade
for whole-distribution evaluation in one launch; scenarios needing
staged hops, substitution chains, churn, or app callbacks keep the
event-driven single-seed `ScenarioRunner` path. Determinism contract (pinned
in tests/test_torch_mc_sweep.py): same spec + seed vector => byte-identical
`SweepReport` on any device, and every per-seed lane is exact-equal to an
independent single-seed run.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.fabric import FAR_WINDOW, Fabric
from ..device import default_device
from ..core.jit_core import SprayProgram, spray_single, stack_draws, sweep_lanes
from .runner import PolicyReport, ScenarioReport
from .spec import ClosedLoopWorkload, ScenarioSpec, ServingWorkload

__all__ = [
    "MonteCarloSweep",
    "SweepPolicyDist",
    "SweepReport",
    "compile_spray_program",
    "sweepable_names",
    "SWEEP_POLICIES",
]


def sweepable_names() -> List[str]:
    """Library scenarios the fused model can compile: closed-loop spray and
    batched serving streams, without join/leave churn (staged hops, the
    event-driven serving executors, and churn stay on the single-seed
    `ScenarioRunner`)."""
    from .library import SCENARIOS

    return [
        name for name, spec in SCENARIOS.items()
        if (isinstance(spec.workload, ClosedLoopWorkload)
            or (isinstance(spec.workload, ServingWorkload)
                and spec.workload.stream_requests > 0))
        and not any(f.is_churn for f in spec.faults)
    ]

# Policies the fused model knows how to score. The ablation baselines beyond
# round_robin (e.g. "random") have no fused twin yet; the sweep simply skips
# them rather than inventing semantics.
SWEEP_POLICIES = ("tent", "round_robin")

# Healing times are capped here for percentile math: a seed whose fault is
# never healed (no completion after onset) must dominate every healed seed
# without poisoning the arithmetic the way inf would.
HEAL_CAP_MS = 1e9

# Bounds on the estimated round count when the workload is duration-driven:
# enough rounds to cross every fault window that matters, bounded so a
# mis-estimated service time cannot explode compile shapes.
MIN_ROUNDS = 8
MAX_ROUNDS = 512


def compile_spray_program(spec: ScenarioSpec, *,
                          rounds: Optional[int] = None) -> SprayProgram:
    """Lower `spec` to a `SprayProgram`. Closed-loop workloads and batched
    serving streams only — the sweep models the spray loop, not the
    event-driven serving/cluster executors."""
    from .workloads import _stream_endpoints

    wl = spec.workload
    if isinstance(wl, ServingWorkload) and wl.stream_requests > 0:
        if any(f.is_churn for f in spec.faults):
            raise ValueError(
                "join/leave churn cannot be compiled into a single-engine "
                "spray program")
        return _compile_serving_stream(spec, rounds=rounds)
    if not isinstance(wl, ClosedLoopWorkload):
        raise ValueError(
            f"MonteCarloSweep models closed-loop spray scenarios and "
            f"batched serving streams; {spec.name!r} runs "
            f"{type(wl).__name__} — use the event-driven ScenarioRunner "
            "for it")
    if any(f.is_churn for f in spec.faults):
        raise ValueError(
            "join/leave churn cannot be compiled into a single-engine "
            "spray program")
    # Probe engine: full environment installed (rail derating, fault
    # program, turbulence), clock never stepped — so the fault windows and
    # telemetry priors snapshot below are exactly the t=0 state every
    # single-seed run starts from. Built with the tent policy so the stage
    # candidates carry tier penalties; the candidate *set* is
    # policy-independent.
    engine, _ = _probe_engine(spec)
    src, dst, block = _stream_endpoints(engine, wl, 0)
    b = engine.allocate_batch()
    engine.submit_transfer(
        b, [(src.segment_id, 0, dst.segment_id, 0, block)])
    tcb = engine._batches[b].transfers[0]
    sc = engine._stage_cands(tcb, 0)
    if not sc.paths:
        raise ValueError(
            f"{spec.name!r}: probe transfer resolved no stage-0 candidates")

    n_slices = max(1, min(spec.engine.max_slices,
                          math.ceil(block / spec.engine.slice_bytes)))
    length = float(block) / n_slices
    wave = wl.streams * max(1, wl.batch_size) * n_slices

    if rounds is None:
        if wl.iters > 0:
            rounds = wl.iters
        else:
            # duration-driven: rounds to cover the declared horizon at the
            # aggregate nominal rate, with 20% headroom for faults
            agg = float(np.sum(np.where(np.isfinite(sc.penalty),
                                        sc.bandwidth, 0.0)))
            round_time = wave * length / max(agg, 1.0)
            rounds = int(np.clip(
                math.ceil(wl.duration / max(round_time, 1e-9) * 1.2),
                MIN_ROUNDS, MAX_ROUNDS))

    return _finish_program(spec, engine, sc, rounds=int(rounds),
                           wave=int(wave), length=length)


def _probe_engine(spec: ScenarioSpec):
    """The probe engine `ScenarioRunner` would build for the tent policy.
    It only resolves candidates and never steps, so a jitted core the spec
    may ask for is held on the CPU."""
    from .runner import ScenarioRunner

    return ScenarioRunner(spec, device="cpu").build_engine("tent")


def _compile_serving_stream(spec: ScenarioSpec, *,
                            rounds: Optional[int] = None) -> SprayProgram:
    """Lower a batched serving-stream scenario: the spray workload is the
    per-tick cold-cohort promotion batches (store DRAM -> serving GPU HBM),
    so the probe transfer is one mean-sized nonzero cohort and each round
    models one cohort tick. Compute phases (prefill/decode) are outside the
    fused model on purpose — they are policy-invariant, so the transfer
    distribution is the part worth sweeping."""
    from ..core import Location, MemoryKind
    from .traffic import TrafficSpec, promotion_bytes

    wl = spec.workload
    engine, _ = _probe_engine(spec)
    stream = TrafficSpec(
        requests=wl.stream_requests, arrival_rate=wl.arrival_rate,
        zipf_alpha=wl.zipf_alpha, groups=wl.traffic_groups,
        input_tokens=wl.input_tokens, output_tokens=wl.output_tokens,
    ).generate()
    promo = promotion_bytes(
        stream, prefix_frac=wl.prefix_frac,
        kv_bytes_per_token=wl.stream_kv_bytes_per_token,
        resident_s=wl.resident_s)
    # the batched stepper's tick grouping: one promotion batch per tick
    # with at least one cold request in it
    tick_ids = np.floor(stream.arrival / wl.tick_s).astype(np.int64)
    cohorts = np.zeros(int(tick_ids[-1]) + 1)
    np.add.at(cohorts, tick_ids, promo)
    nonzero = cohorts[cohorts > 0]
    if nonzero.size == 0:
        raise ValueError(
            f"{spec.name!r}: the stream promotes no bytes (every prefix "
            "group stays resident) — nothing for the sweep to model")
    block = int(nonzero.mean())

    numa = engine.topology.spec.node.gpu_numa(0)
    src = engine.register_segment(
        Location(node=wl.store_node, kind=MemoryKind.HOST_DRAM,
                 device=0, numa=0),
        block, name="sweep-probe-store", materialize=False)
    dst = engine.register_segment(
        Location(node=wl.gpu_node, kind=MemoryKind.DEVICE_HBM,
                 device=0, numa=numa),
        block, name="sweep-probe-gpu", materialize=False)
    b = engine.allocate_batch()
    engine.submit_transfer(
        b, [(src.segment_id, 0, dst.segment_id, 0, block)])
    tcb = engine._batches[b].transfers[0]
    sc = engine._stage_cands(tcb, 0)
    if not sc.paths:
        raise ValueError(
            f"{spec.name!r}: probe transfer resolved no stage-0 candidates")

    n_slices = max(1, min(spec.engine.max_slices,
                          math.ceil(block / spec.engine.slice_bytes)))
    if rounds is None:
        rounds = int(np.clip(nonzero.size, MIN_ROUNDS, MAX_ROUNDS))
    return _finish_program(spec, engine, sc, rounds=int(rounds),
                           wave=int(n_slices),
                           length=float(block) / n_slices)


def _finish_program(spec: ScenarioSpec, engine, sc, *, rounds: int,
                    wave: int, length: float) -> SprayProgram:
    """Snapshot the probe engine's candidate rails, telemetry priors, and
    installed fault/degradation schedule into the fixed-shape program."""
    D = len(sc.paths)
    slots = sc.local_slot
    store = engine.store
    bw_src = np.empty(D)
    bw_dst = np.empty(D)
    latency = np.empty(D)
    for i, p in enumerate(sc.paths):
        bw_src[i] = p.local.bandwidth * p.bw_factor
        bw_dst[i] = (p.remote.bandwidth * p.bw_factor
                     if p.remote is not None else np.inf)
        latency[i] = p.local.base_latency + sc.extra_latency[i]

    fw = engine.fabric.fault_window_arrays()
    row = {int(lid): k for k, lid in enumerate(fw["link_ids"])}
    kf = fw["fail_start"].shape[1]
    kd = fw["deg_start"].shape[1]
    # fail windows: union of the src and dst legs (either side down kills
    # the transfer); degradations stay per side (the fabric takes the min
    # of the two sides' effective bandwidths)
    fail_start = np.full((D, 2 * kf), FAR_WINDOW)
    fail_end = np.full((D, 2 * kf), FAR_WINDOW)
    degs_start = np.full((D, kd), FAR_WINDOW)
    degs_end = np.full((D, kd), FAR_WINDOW)
    degs_factor = np.ones((D, kd))
    degd_start = np.full((D, kd), FAR_WINDOW)
    degd_end = np.full((D, kd), FAR_WINDOW)
    degd_factor = np.ones((D, kd))
    for i, (lid, rid) in enumerate(zip(sc.local_links, sc.remote_links)):
        r = row[lid]
        fail_start[i, :kf] = fw["fail_start"][r]
        fail_end[i, :kf] = fw["fail_end"][r]
        degs_start[i] = fw["deg_start"][r]
        degs_end[i] = fw["deg_end"][r]
        degs_factor[i] = fw["deg_factor"][r]
        if rid is not None:
            rr = row[rid]
            fail_start[i, kf:] = fw["fail_start"][rr]
            fail_end[i, kf:] = fw["fail_end"][rr]
            degd_start[i] = fw["deg_start"][rr]
            degd_end[i] = fw["deg_end"][rr]
            degd_factor[i] = fw["deg_factor"][rr]

    return SprayProgram(
        n_rails=D,
        rounds=int(rounds),
        wave=int(wave),
        length=length,
        gamma=spec.engine.gamma,
        detect=Fabric.FAIL_DETECT_LATENCY,
        jitter=engine.fabric.links[sc.local_links[0]].jitter,
        bw_score=np.asarray(sc.bandwidth, dtype=np.float64),
        bw_src=bw_src,
        bw_dst=bw_dst,
        penalty=np.asarray(sc.penalty, dtype=np.float64),
        latency=latency,
        beta0=store.beta0_arr[slots].astype(np.float64),
        beta1=store.beta1_arr[slots].astype(np.float64),
        ewma_alpha=store.ewma_alpha_arr[slots].astype(np.float64),
        beta0_alpha=store.beta0_alpha_arr[slots].astype(np.float64),
        fail_start=fail_start,
        fail_end=fail_end,
        degs_start=degs_start,
        degs_end=degs_end,
        degs_factor=degs_factor,
        degd_start=degd_start,
        degd_end=degd_end,
        degd_factor=degd_factor,
    )


# ---------------------------------------------------------------------------
# Distributions and the report
# ---------------------------------------------------------------------------

_BOOTSTRAP_B = 200


def _percentiles(vals: np.ndarray) -> Tuple[float, float, float]:
    return (float(np.percentile(vals, 50)),
            float(np.percentile(vals, 99)),
            float(np.percentile(vals, 99.9)))


def _bootstrap_ci(vals: np.ndarray, q: float,
                  rng: np.random.Generator) -> Tuple[float, float]:
    """Seeded percentile-bootstrap 95% CI of the q-th percentile."""
    n = vals.shape[0]
    idx = rng.integers(0, n, size=(_BOOTSTRAP_B, n))
    stats = np.percentile(vals[idx], q, axis=1)
    return (float(np.percentile(stats, 2.5)),
            float(np.percentile(stats, 97.5)))


def _healing_ms(healing_s: np.ndarray) -> np.ndarray:
    """Per-seed healing times in virtual ms; -1 = scenario had no fault
    onset before that seed's makespan; never-healed seeds cap at
    HEAL_CAP_MS."""
    out = np.where(healing_s < 0.0, -1.0,
                   np.minimum(healing_s * 1e3, HEAL_CAP_MS))
    return out.astype(np.float64)


@dataclasses.dataclass(frozen=True)
class SweepPolicyDist:
    """One policy's per-seed metric vectors plus their summary stats."""

    policy: str
    healing_ms: Tuple[float, ...]  # -1 = no fault onset for that seed
    throughput: Tuple[float, ...]
    bytes_ok: Tuple[float, ...]
    lost: Tuple[float, ...]
    makespan: Tuple[float, ...]
    summary: Dict[str, float]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _summarize(policy: str, res: Dict[str, np.ndarray],
               base_seed: int) -> SweepPolicyDist:
    rng = np.random.default_rng(base_seed * 9176 + 11)
    heal = _healing_ms(res["healing_s"])
    healed = heal[heal >= 0.0]
    summary: Dict[str, float] = {}
    if healed.size:
        p50, p99, p999 = _percentiles(healed)
        summary["healing_p50_ms"] = p50
        summary["healing_p99_ms"] = p99
        summary["healing_p999_ms"] = p999
        lo, hi = _bootstrap_ci(healed, 50, rng)
        summary["healing_p50_ci_lo"], summary["healing_p50_ci_hi"] = lo, hi
        lo, hi = _bootstrap_ci(healed, 99.9, rng)
        summary["healing_p999_ci_lo"], summary["healing_p999_ci_hi"] = lo, hi
    else:
        for k in ("healing_p50_ms", "healing_p99_ms", "healing_p999_ms",
                  "healing_p50_ci_lo", "healing_p50_ci_hi",
                  "healing_p999_ci_lo", "healing_p999_ci_hi"):
            summary[k] = -1.0
    thr = res["throughput"]
    summary["throughput_p50"] = float(np.percentile(thr, 50))
    summary["throughput_p01"] = float(np.percentile(thr, 1))
    lo, hi = _bootstrap_ci(thr, 50, rng)
    summary["throughput_p50_ci_lo"], summary["throughput_p50_ci_hi"] = lo, hi
    summary["lost_total"] = float(np.sum(res["lost"]))
    return SweepPolicyDist(
        policy=policy,
        healing_ms=tuple(float(v) for v in heal),
        throughput=tuple(float(v) for v in thr),
        bytes_ok=tuple(float(v) for v in res["bytes_ok"]),
        lost=tuple(float(v) for v in res["lost"]),
        makespan=tuple(float(v) for v in res["makespan"]),
        summary=summary,
    )


@dataclasses.dataclass(frozen=True)
class SweepReport:
    """The distributional analogue of `ScenarioReport`: per-policy per-seed
    vectors + summaries, scenario-level violations evaluated against the
    spec's sweep expectations (`healing_p999_ms`,
    `throughput_p50_vs_baseline`)."""

    scenario: str
    n_seeds: int
    base_seed: int
    fault_jitter: float
    rounds: int
    wave: int
    policies: Dict[str, SweepPolicyDist]
    violations: Tuple[str, ...]
    spec: dict

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "scenario": self.scenario,
            "ok": self.ok,
            "n_seeds": self.n_seeds,
            "base_seed": self.base_seed,
            "fault_jitter": self.fault_jitter,
            "rounds": self.rounds,
            "wave": self.wave,
            "violations": list(self.violations),
            "policies": {p: d.to_dict() for p, d in self.policies.items()},
            "spec": self.spec,
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def to_scenario_report(self) -> ScenarioReport:
        """Project the distribution into the `tent-scenario-reports/v1`
        shape `benchmarks.diff` gates: throughput = the policy's P50 across
        seeds, recovery/stall = healing P50/P99.9 ms, per-seed spread in
        the latency percentiles and the full summary in `extra`."""
        policies: Dict[str, PolicyReport] = {}
        for name, d in self.policies.items():
            mk = np.asarray(d.makespan)
            policies[name] = PolicyReport(
                policy=name,
                ok=True,
                bytes_total=int(np.percentile(np.asarray(d.bytes_ok), 50)),
                makespan=float(np.percentile(mk, 50)),
                throughput=d.summary["throughput_p50"],
                requests=self.n_seeds,
                latency_p50=float(np.percentile(mk, 50)),
                latency_p90=float(np.percentile(mk, 90)),
                latency_p99=float(np.percentile(mk, 99)),
                retries=0,
                exclusions=0,
                readmissions=0,
                substitutions=0,
                batches_failed=0,
                lost_slices=int(np.percentile(np.asarray(d.lost), 50)),
                rail_imbalance=0.0,
                recovery_ms=d.summary["healing_p50_ms"],
                stall_ms=d.summary["healing_p999_ms"],
                bytes_by_rail={},
                buckets_gbps=[],
                extra=dict(d.summary),
            )
        spec = dict(self.spec)
        spec["mc"] = {"n_seeds": self.n_seeds, "base_seed": self.base_seed,
                      "fault_jitter": self.fault_jitter,
                      "rounds": self.rounds, "wave": self.wave}
        return ScenarioReport(
            scenario=f"{self.scenario}::mc",
            policies=policies,
            violations=list(self.violations),
            spec=spec,
        )


# ---------------------------------------------------------------------------
# The sweep itself
# ---------------------------------------------------------------------------


class MonteCarloSweep:
    """Run one scenario over `n_seeds` fault draws.

    `fault_jitter` scales the per-seed perturbation of every declared fault
    window (onset and duration) and degradation depth: 0 replays the exact
    declared schedule N times (only transfer-level service jitter varies
    per seed), 0.25 (default) explores +-25% around it. Seed i's draws
    come from `make_draws(base_seed=base_seed, seed_index=i)`, so the
    distribution is a pure function of (spec, n_seeds, base_seed,
    fault_jitter), on any device. `device` is where the lanes run: None
    means CUDA (the `spray_sim` kernel), which raises without a card;
    "cpu" runs the plain torch sim.
    """

    def __init__(self, spec: ScenarioSpec, *, n_seeds: int = 64,
                 fault_jitter: float = 0.25,
                 base_seed: Optional[int] = None,
                 rounds: Optional[int] = None,
                 policies: Optional[Sequence[str]] = None,
                 device=None):
        if n_seeds < 1:
            raise ValueError("n_seeds must be >= 1")
        self.spec = spec
        self.device = default_device(device)
        self.n_seeds = int(n_seeds)
        self.fault_jitter = float(fault_jitter)
        self.base_seed = spec.seed if base_seed is None else int(base_seed)
        wanted = tuple(policies if policies is not None else spec.policies)
        self.policies = tuple(p for p in wanted if p in SWEEP_POLICIES)
        if not self.policies:
            raise ValueError(
                f"none of {wanted!r} has a fused sweep model "
                f"(supported: {SWEEP_POLICIES})")
        self.program = compile_spray_program(spec, rounds=rounds)

    def run(self) -> SweepReport:
        # the draws do not depend on the policy: one draw of the seeds
        # serves every policy's sweep
        draws = stack_draws(self.program, self.n_seeds, base_seed=self.base_seed)
        dists = {
            pol: _summarize(
                pol,
                sweep_lanes(self.program, draws, policy=pol,
                            fault_jitter=self.fault_jitter, device=self.device),
                self.base_seed)
            for pol in self.policies
        }
        return SweepReport(
            scenario=self.spec.name,
            n_seeds=self.n_seeds,
            base_seed=self.base_seed,
            fault_jitter=self.fault_jitter,
            rounds=self.program.rounds,
            wave=self.program.wave,
            policies=dists,
            violations=tuple(self._violations(dists)),
            spec=self.spec.to_dict(),
        )

    def run_single(self, seed_index: int,
                   policy: str = "tent") -> Tuple[float, ...]:
        """One seed run on its own, for exact-parity pinning against the
        matching lane of a sweep: `(throughput, healing_s, bytes_ok, lost,
        makespan)`."""
        return spray_single(
            self.program, base_seed=self.base_seed, seed_index=seed_index,
            policy=policy, fault_jitter=self.fault_jitter, device=self.device)

    def _violations(self, dists: Dict[str, SweepPolicyDist]) -> List[str]:
        exp = self.spec.expectations
        primary = self.policies[0]
        out: List[str] = []
        prim = dists[primary]
        if exp.healing_p999_ms > 0:
            p999 = prim.summary["healing_p999_ms"]
            if p999 < 0:
                out.append(
                    f"{primary}: healing_p999_ms expected <= "
                    f"{exp.healing_p999_ms:.1f}ms but no seed saw a fault "
                    "onset before its makespan")
            elif p999 > exp.healing_p999_ms:
                out.append(
                    f"{primary}: healing P99.9 {p999:.2f}ms exceeds "
                    f"{exp.healing_p999_ms:.1f}ms over "
                    f"{self.n_seeds} seeds")
        if exp.throughput_p50_vs_baseline > 0:
            p50 = prim.summary["throughput_p50"]
            for pol, d in dists.items():
                if pol == primary:
                    continue
                floor = exp.throughput_p50_vs_baseline * \
                    d.summary["throughput_p50"]
                if p50 < floor:
                    out.append(
                        f"{primary}: throughput P50 {p50 / 1e9:.3f}GB/s < "
                        f"{exp.throughput_p50_vs_baseline:.2f}x {pol} "
                        f"({d.summary['throughput_p50'] / 1e9:.3f}GB/s)")
        return out
