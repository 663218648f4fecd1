"""Cluster control plane: multi-engine TENT with global telemetry diffusion
and failure-rumor gossip over a modeled lossy/delayed channel, partial
membership views, and engine join/leave churn. Carried over from `repro.cluster` (its README
describes the design)."""
from .control_plane import ClusterParams, EngineRole, TentCluster
from .diffusion import GlobalLoadTable
from .gossip import GossipChannel, PeerSampler
from .membership import ClusterMembership

__all__ = [
    "ClusterParams", "EngineRole", "TentCluster",
    "GlobalLoadTable", "ClusterMembership", "GossipChannel", "PeerSampler",
]
