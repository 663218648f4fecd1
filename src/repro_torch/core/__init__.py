"""TENT core: declarative slice-spraying data-movement engine (the paper's
primary contribution), plus the discrete-event fabric it executes on in this
reproduction. Host-side numpy, carried over from `repro.core` unchanged
except that the jitted core (`EngineConfig.jit_core`) is not ported yet."""
from .engine import BatchResult, EngineConfig, TentEngine
from .calqueue import CalendarQueue
from .fabric import FAR_WINDOW, Fabric, FabricConfig
from .plan import (
    Orchestrator,
    RouteOption,
    Stage,
    StageCandidates,
    TransportPlan,
    build_stage_candidates,
)
from .resilience import HealthConfig, HealthMonitor
from .scheduler import (
    Candidate,
    HashPolicy,
    PinnedPolicy,
    Policy,
    RoundRobinPolicy,
    StaticBest2Policy,
    TentPolicy,
    make_policy,
    tent_choose_wave,
)
from .segments import Segment, SegmentManager, device_segment, file_segment, host_segment
from .slicing import decompose
from .telemetry import LinkTelemetry, TelemetryStore
from .topology import DEFAULT_TIER_PENALTY, FabricSpec, LinkDesc, NodeSpec, Topology
from .types import (
    BatchState,
    LinkClass,
    Location,
    MemoryKind,
    Slice,
    SliceState,
    TentError,
    TransferRequest,
)

__all__ = [
    "BatchResult", "CalendarQueue", "EngineConfig", "TentEngine", "FAR_WINDOW",
    "Fabric", "FabricConfig",
    "Orchestrator",
    "RouteOption", "Stage", "StageCandidates", "TransportPlan",
    "build_stage_candidates", "HealthConfig", "HealthMonitor",
    "Candidate", "HashPolicy", "PinnedPolicy", "Policy", "RoundRobinPolicy",
    "StaticBest2Policy", "TentPolicy", "make_policy",
    "tent_choose_wave", "Segment", "SegmentManager", "device_segment",
    "file_segment", "host_segment", "decompose", "LinkTelemetry",
    "TelemetryStore", "DEFAULT_TIER_PENALTY", "FabricSpec", "LinkDesc",
    "NodeSpec", "Topology", "BatchState", "LinkClass", "Location",
    "MemoryKind", "Slice", "SliceState", "TentError", "TransferRequest",
]
