"""Declarative scenarios, carried over from `repro.scenarios`: one spec
consumed by the engine and the scenario runner, the 25-entry library, the
workload executors, and the Monte Carlo seed sweep."""
from .library import SCENARIOS, get, names
from .runner import PolicyReport, ScenarioReport, ScenarioRunner, run_scenario
from .sweep import (
    MonteCarloSweep,
    SweepPolicyDist,
    SweepReport,
    compile_spray_program,
)
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
from .workloads import (
    StreamDriver,
    WorkloadOutcome,
    add_background_turbulence,
    add_tenant_contention,
    drive_closed_loop,
    drive_streams,
    gpu_loc,
    host_loc,
    run_closed_loop,
    run_cluster_workload,
    run_serve,
    run_serving,
    run_workload,
)

__all__ = [
    "SCENARIOS", "get", "names", "PolicyReport", "ScenarioReport",
    "ScenarioRunner", "run_scenario", "MonteCarloSweep", "SweepPolicyDist",
    "SweepReport", "compile_spray_program",
    "BackgroundSpec", "CheckpointWorkload",
    "ClosedLoopWorkload", "ClusterWorkload", "EngineParams", "Expectations",
    "FaultEvent", "ScenarioSpec", "ServeWorkload", "ServingWorkload",
    "TopologyParams", "degrade_ramp", "engine_join", "engine_leave",
    "flap_storm", "rail_outage", "StreamDriver", "WorkloadOutcome",
    "add_background_turbulence", "add_tenant_contention", "drive_closed_loop",
    "drive_streams", "gpu_loc", "host_loc", "run_closed_loop",
    "run_cluster_workload", "run_serve", "run_serving", "run_workload",
]
