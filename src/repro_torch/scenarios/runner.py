"""Scenario execution: spec in, structured report out.

`ScenarioRunner` materializes the engine(s) a spec describes, installs the
fault program and background contention on the fabric, drives the workload
for every policy in the ablation list, and reduces the outcome to one
`ScenarioReport`: throughput, latency percentiles, per-rail byte balance,
recovery/stall time after fault onsets, retry/exclusion counters, and the
zero-lost-slice audit. `report.violations` evaluates the spec's declared
expectations, so the regression tests, the benchmark runner, and ad-hoc
experiments all agree on what "this scenario is healthy" means.

Everything runs on the virtual clock from a fixed seed: the same spec always
yields the same report, byte for byte.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core import LinkClass, TentEngine
from ..obs import MetricsRegistry
from .spec import ClusterWorkload, FaultEvent, ScenarioSpec
from .workloads import (
    WorkloadOutcome,
    add_background_turbulence,
    add_tenant_contention,
    run_cluster_workload,
    run_workload,
)

RAIL_FULL_HORIZON = 1e15  # "forever" for rail_bw_factors degradations


@dataclasses.dataclass
class PolicyReport:
    """Metrics for one (scenario, policy) run."""

    policy: str
    ok: bool
    bytes_total: int
    makespan: float
    throughput: float  # bytes/s (closed-loop & checkpoint) or tokens/s (serve)
    requests: int
    latency_p50: float
    latency_p90: float
    latency_p99: float
    retries: int
    exclusions: int
    readmissions: int
    substitutions: int
    batches_failed: int
    lost_slices: int
    rail_imbalance: float  # max/mean bytes over the busiest node's RDMA rails
    recovery_ms: float  # worst post-onset throughput dip (-1 when n/a)
    stall_ms: float  # worst post-onset completion gap (-1 when n/a)
    bytes_by_rail: Dict[str, int]
    buckets_gbps: List[float]
    extra: Dict[str, float]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ScenarioReport:
    scenario: str
    policies: Dict[str, PolicyReport]
    violations: List[str]
    spec: dict

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "scenario": self.scenario,
            "ok": self.ok,
            "violations": list(self.violations),
            "policies": {p: r.to_dict() for p, r in self.policies.items()},
            "spec": self.spec,
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)


class ScenarioRunner:
    def __init__(self, spec: ScenarioSpec, *, device=None):
        """`device` is where the engines' jitted core runs when the spec
        turns `jit_core` on (None = CUDA, which raises without a card); it is
        not used otherwise."""
        self.spec = spec
        self.device = device

    # ------------------------------------------------------------- engine
    def build_engine(self, policy: str,
                     recorder=None) -> Tuple[TentEngine, Set[int]]:
        """One engine with the spec's topology, engine knobs, heterogeneity,
        fault program, and background contention installed. Returns the
        engine plus the batch ids owned by background tenants (excluded from
        the workload audit)."""
        spec = self.spec
        if any(f.is_churn for f in spec.faults):
            raise ValueError(
                "join/leave churn events need a cluster workload "
                "(ClusterWorkload) — a single engine has no membership")
        engine = TentEngine(
            spec.topology.to_fabric_spec(),
            config=spec.engine.to_engine_config(policy),
            seed=spec.seed,
            device=self.device,
        )
        if recorder is not None:
            # before the environment install, so schedule-time fault records
            # (degradation windows) land in the trace
            engine.attach_recorder(recorder)
        self._install_environment(engine)
        tenant_batches: Set[int] = set()
        bg = spec.background
        if bg.tenant_streams > 0:
            add_tenant_contention(
                engine, streams=bg.tenant_streams, block=bg.tenant_block,
                record=tenant_batches)
        return engine, tenant_batches

    def _install_environment(self, engine: TentEngine) -> None:
        """The spec's fabric-level environment — heterogeneity derating,
        fault program, background turbulence — installed through one engine's
        topology/fabric handles (on a cluster every engine shares them)."""
        spec = self.spec
        for nic_idx, factor in spec.topology.rail_bw_factors:
            for node in range(spec.topology.n_nodes):
                link = engine.topology.rdma_nic(node, nic_idx)
                engine.fabric.schedule_degradation(
                    link.link_id, at=0.0, until=RAIL_FULL_HORIZON, factor=factor)
        for f in spec.faults:
            if not f.is_churn:  # join/leave are cluster events, not wire faults
                self._apply_fault(engine, f)
        bg = spec.background
        if bg.turbulence_severity > 0:
            add_background_turbulence(
                engine, seed=bg.turbulence_seed, horizon=bg.turbulence_horizon,
                severity=bg.turbulence_severity)

    @staticmethod
    def _apply_fault(engine: TentEngine, f: FaultEvent) -> None:
        link = engine.topology.rdma_nic(f.node, f.nic)
        if f.kind == "fail":
            engine.fabric.schedule_failure(link.link_id, at=f.at, recover_at=f.until)
        else:
            engine.fabric.schedule_degradation(
                link.link_id, at=f.at, until=f.until, factor=f.factor)

    # ------------------------------------------------------------- cluster
    def build_cluster(self, policy: str, recorder=None):
        """Materialize the `TentCluster` a ClusterWorkload describes: one
        engine per role on a shared fabric, plus the spec's faults and
        turbulence. Policy names like "tent+diffusion" enable the cluster
        control plane (global load table + failure rumors); plain names run
        the same engines as silos."""
        from ..cluster import ClusterParams, EngineRole, TentCluster

        spec = self.spec
        wl = spec.workload
        base, _, flag = policy.partition("+")
        if flag not in ("", "diffusion"):
            raise ValueError(
                f"unknown cluster policy flag {flag!r} in {policy!r} "
                "(supported: '+diffusion')")
        roles = []
        if wl.pattern == "kv_incast":
            roles += [EngineRole(f"prefill{n}", (n,), base) for n in wl.producer_nodes]
            roles.append(EngineRole("decode", tuple(wl.consumer_nodes), base))
        else:  # ckpt_broadcast
            roles.append(EngineRole("trainer", tuple(wl.producer_nodes), base))
            roles += [EngineRole(f"serving{n}", (n,), base) for n in wl.consumer_nodes]
        if wl.contender_nodes:
            roles.append(EngineRole("cache", tuple(wl.contender_nodes), wl.contender_policy))
        params = ClusterParams(
            diffusion=(flag == "diffusion"),
            global_weight=wl.global_weight,
            diffusion_period=wl.diffusion_period,
            diffusion_staleness=wl.diffusion_staleness,
            gossip_delay=wl.gossip_delay,
            gossip_loss=wl.gossip_loss,
            gossip_link_delay=wl.gossip_link_delay,
            fanout=wl.fanout,
        )
        if spec.background.tenant_streams > 0:
            raise ValueError(
                "background.tenant_streams is not supported for cluster "
                "scenarios — model co-located tenants as the contender role "
                "(ClusterWorkload.contender_nodes)")
        cluster = TentCluster(
            spec.topology.to_fabric_spec(), roles,
            engine_config=spec.engine.to_engine_config(base),
            params=params, seed=spec.seed, device=self.device,
        )
        if recorder is not None:
            cluster.attach_recorder(recorder)
        self._install_environment(next(iter(cluster.engines.values())))
        return cluster

    # ------------------------------------------------------------- one run
    def run_policy(self, policy: str, *, recorder=None) -> PolicyReport:
        """Run one policy. `recorder` optionally attaches a
        `repro_torch.obs.FlightRecorder` before the workload starts; attaching
        one never changes the resulting report (parity-pinned in
        tests/test_torch_obs.py). All three workload kinds surface their engine/
        cluster counters through one `MetricsRegistry` collection, so
        `ScenarioReport.extra` carries a uniform counter surface.

        The whole body runs under `maybe_sanitized()`: with REPRO_SANITIZE=1
        any engine-side wall-clock or global-RNG call raises (the dynamic
        side of the tentlint no-wall-clock/no-global-rng rules); with the
        env var unset this is a nullcontext and costs nothing."""
        from ..analysis.sanitize import maybe_sanitized

        wl = self.spec.workload
        reg = MetricsRegistry()
        with maybe_sanitized():
            if isinstance(wl, ClusterWorkload):
                cluster = self.build_cluster(policy, recorder=recorder)
                base = policy.partition("+")[0]
                churn = tuple(f for f in self.spec.faults if f.is_churn)
                outcome, ignore = run_cluster_workload(
                    cluster, wl, churn, join_policy=base)
                audit = cluster.audit(ignore=ignore)["total"]
                counters = cluster.counters()
                cluster.register_metrics(reg)
                return self._reduce(
                    policy, fabric=cluster.fabric, audit=audit,
                    counters={k: counters[k] for k in
                              ("retries", "exclusions", "readmissions",
                               "substitutions")},
                    outcome=outcome, extra=reg.collect())
            engine, tenant_batches = self.build_engine(policy, recorder=recorder)
            outcome = run_workload(engine, wl)
            engine.register_metrics(reg)
            return self._reduce(
                policy, fabric=engine.fabric,
                audit=engine.audit(ignore=tenant_batches),
                counters={
                    "retries": engine.slices_retried,
                    "exclusions": engine.health.exclusions,
                    "readmissions": engine.health.readmissions,
                    "substitutions": engine.backend_substitutions,
                },
                outcome=outcome,
                extra=reg.collect())

    def run(self) -> ScenarioReport:
        reports = {p: self.run_policy(p) for p in self.spec.policies}
        return ScenarioReport(
            scenario=self.spec.name,
            policies=reports,
            violations=self._violations(reports),
            spec=self.spec.to_dict(),
        )

    # ------------------------------------------------------------- metrics
    def _reduce(
        self,
        policy: str,
        *,
        fabric,
        audit: Dict[str, int],
        counters: Dict[str, int],
        outcome: WorkloadOutcome,
        extra: Optional[Dict[str, float]] = None,
    ) -> PolicyReport:
        """Reduce one policy run (single engine or whole cluster: the audit
        and resilience counters arrive pre-aggregated) to a PolicyReport."""
        lost = audit["slices_outstanding"]
        lat = np.asarray([c[2] for c in outcome.completions])
        p50, p90, p99 = (
            (float(np.percentile(lat, q)) for q in (50, 90, 99))
            if lat.size else (0.0, 0.0, 0.0)
        )
        throughput = outcome.extra.get(
            "input_throughput", outcome.bytes_total / max(outcome.makespan, 1e-12))
        buckets = self._buckets(outcome)
        onsets = sorted(f.at for f in self.spec.faults if f.kind == "fail")
        recovery_ms = self._recovery_ms(buckets, onsets) if onsets else -1.0
        stall_ms = self._stall_ms(outcome, onsets) if onsets else -1.0
        rail_bytes = self._rail_bytes(fabric)
        all_extra = dict(outcome.extra)
        all_extra.update(self._class_bytes(fabric))
        all_extra.update(extra or {})
        return PolicyReport(
            policy=policy,
            ok=audit["batches_failed"] == 0 and lost == 0,
            bytes_total=outcome.bytes_total,
            makespan=outcome.makespan,
            throughput=throughput,
            requests=len(outcome.completions),
            latency_p50=p50, latency_p90=p90, latency_p99=p99,
            retries=counters["retries"],
            exclusions=counters["exclusions"],
            readmissions=counters["readmissions"],
            substitutions=counters["substitutions"],
            batches_failed=audit["batches_failed"],
            lost_slices=lost,
            rail_imbalance=self._imbalance(rail_bytes),
            recovery_ms=recovery_ms,
            stall_ms=stall_ms,
            bytes_by_rail={name: b for (_, name), b in rail_bytes.items()},
            buckets_gbps=buckets,
            extra=all_extra,
        )

    def _buckets(self, outcome: WorkloadOutcome) -> List[float]:
        """Completion-bucketized throughput timeline in GB/s."""
        if not outcome.completions:
            return []
        dt = self.spec.bucket
        end = max(t for t, _, _ in outcome.completions)
        out = np.zeros(int(end / dt) + 1)
        for t, nbytes, _ in outcome.completions:
            out[int(t / dt)] += nbytes
        return list(out / dt / 1e9)

    def _recovery_ms(self, buckets: List[float], onsets: List[float]) -> float:
        """Worst consecutive run of post-onset buckets below 50% of the
        healthy (pre-first-onset) median — fig10's dip-duration metric."""
        if not buckets:
            return -1.0
        dt = self.spec.bucket
        first = int(onsets[0] / dt)
        warm = min(2, first)
        healthy_window = buckets[warm:first]
        if not healthy_window:
            return -1.0
        healthy = float(np.median(healthy_window))
        if healthy <= 0:
            return -1.0
        worst = 0
        for onset in onsets:
            dip = 0
            for v in buckets[int(onset / dt):]:
                if v < 0.5 * healthy:
                    dip += 1
                else:
                    break
            worst = max(worst, dip)
        return worst * dt * 1e3

    # finite "never completed again" sentinel: trips any max_stall_ms
    # expectation while keeping reports strict-JSON (inf would serialize as
    # the non-standard `Infinity` token)
    NEVER_RECOVERED_MS = 1e12

    @classmethod
    def _stall_ms(cls, outcome: WorkloadOutcome, onsets: List[float]) -> float:
        """Worst time from a fault onset to the next successful completion:
        how long the engine takes to resume making progress when capacity
        drops too far for the dip metric to be meaningful."""
        times = sorted(t for t, _, _ in outcome.completions)
        if not times:
            return -1.0
        worst = 0.0
        for onset in onsets:
            i = int(np.searchsorted(np.asarray(times), onset))
            if i >= len(times):
                return cls.NEVER_RECOVERED_MS
            worst = max(worst, times[i] - onset)
        return worst * 1e3

    @staticmethod
    def _rail_bytes(fabric) -> Dict[Tuple[int, str], int]:
        return {
            (l.desc.node, l.desc.name): l.bytes_completed
            for l in fabric.links.values()
            if l.desc.link_class == LinkClass.RDMA
        }

    @staticmethod
    def _class_bytes(fabric) -> Dict[str, float]:
        """Completed bytes per interconnect class ("bytes_rdma", "bytes_ub",
        ...) — how the portability scenarios assert which fabric actually
        carried the traffic."""
        out: Dict[str, float] = {}
        for l in fabric.links.values():
            key = f"bytes_{l.desc.link_class.value}"
            out[key] = out.get(key, 0.0) + float(l.bytes_completed)
        return out

    @staticmethod
    def _imbalance(rail_bytes: Dict[Tuple[int, str], int]) -> float:
        """max/mean byte ratio across the RDMA rails of the busiest node —
        1.0 is a perfect spray; large values mean a few rails carried it all."""
        per_node: Dict[int, List[int]] = {}
        for (node, _), b in rail_bytes.items():
            per_node.setdefault(node, []).append(b)
        busiest = max(per_node.values(), key=sum, default=[])
        if not busiest or sum(busiest) == 0:
            return 0.0
        return max(busiest) / (sum(busiest) / len(busiest))

    # ------------------------------------------------------------- checks
    def _violations(self, reports: Dict[str, PolicyReport]) -> List[str]:
        exp = self.spec.expectations
        primary = reports[self.spec.primary_policy]
        out: List[str] = []
        if exp.zero_lost_slices:
            for p, r in reports.items():
                if r.batches_failed:
                    out.append(f"{p}: {r.batches_failed} app-visible batch failures")
                if r.lost_slices:
                    out.append(f"{p}: {r.lost_slices} slices unaccounted for")
        if exp.tent_vs_baseline > 0:
            for p in self.spec.baseline_policies:
                base = reports[p]
                if primary.throughput < exp.tent_vs_baseline * base.throughput:
                    out.append(
                        f"{primary.policy} throughput {primary.throughput:.3e} < "
                        f"{exp.tent_vs_baseline:.2f} x {p} ({base.throughput:.3e})")
        if exp.max_recovery_ms > 0 and primary.recovery_ms >= 0:
            if primary.recovery_ms > exp.max_recovery_ms:
                out.append(
                    f"{primary.policy} recovery {primary.recovery_ms:.1f} ms > "
                    f"{exp.max_recovery_ms:.0f} ms budget")
        if exp.max_stall_ms > 0 and primary.stall_ms >= 0:
            if primary.stall_ms > exp.max_stall_ms:
                out.append(
                    f"{primary.policy} stall {primary.stall_ms:.1f} ms > "
                    f"{exp.max_stall_ms:.0f} ms budget")
        if exp.max_rail_imbalance > 0 and primary.rail_imbalance > exp.max_rail_imbalance:
            out.append(
                f"{primary.policy} rail imbalance {primary.rail_imbalance:.2f} > "
                f"{exp.max_rail_imbalance:.2f}")
        for attr, factor in (("latency_p99", exp.p99_vs_baseline),
                             ("latency_p50", exp.p50_vs_baseline)):
            if factor <= 0:
                continue
            for p in self.spec.baseline_policies:
                ours, theirs = getattr(primary, attr), getattr(reports[p], attr)
                if theirs > 0 and ours > factor * theirs:
                    out.append(
                        f"{primary.policy} {attr} {ours:.4f}s > "
                        f"{factor:.2f} x {p} ({theirs:.4f}s)")
        # serving SLOs (reported by the serving executors via `extra`)
        if exp.ttft_p90_vs_baseline > 0:
            ours = primary.extra.get("p90_ttft_s", 0.0)
            for p in self.spec.baseline_policies:
                theirs = reports[p].extra.get("p90_ttft_s", 0.0)
                if theirs > 0 and ours > exp.ttft_p90_vs_baseline * theirs:
                    out.append(
                        f"{primary.policy} TTFT P90 {ours:.4f}s > "
                        f"{exp.ttft_p90_vs_baseline:.2f} x {p} ({theirs:.4f}s)")
        for key, limit, label in (
                ("p99_ttft_s", exp.max_ttft_p99_s, "TTFT P99"),
                ("p99_tpot_s", exp.max_tpot_p99_s, "TPOT P99")):
            if limit > 0 and primary.extra.get(key, 0.0) > limit:
                out.append(
                    f"{primary.policy} {label} {primary.extra[key]:.4f}s > "
                    f"{limit:.4f}s SLO")
        return out


def run_scenario(spec: ScenarioSpec) -> ScenarioReport:
    return ScenarioRunner(spec).run()
