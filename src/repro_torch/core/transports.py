"""Pluggable transport backends (paper §3.2).

Each fabric (RDMA, NVLink, MNNVL, Ascend UB, TCP, SHM, PCIe staging, file
I/O) is a thin backend conforming to one interface: it declares feasibility
for a (src, dst) location pair and enumerates the *wire paths* (schedulable
local device + remote endpoint + affinity tier) that could carry a slice.
All mechanism (queueing, service time, failures) lives in the fabric
simulator; all policy (which path a slice takes) lives in the scheduler.
That separation is the paper's point: backends stay under ~100 lines here,
mirroring the <800 LOC claim for production backends.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .topology import LinkDesc, Topology
from .types import LinkClass, Location, MemoryKind


@dataclasses.dataclass(frozen=True)
class WirePath:
    """A concrete way to carry a slice: the local schedulable device, the
    remote endpoint it pairs with (two-resource serialization), the affinity
    tier for Algorithm 1's penalty, and submission-side latency."""

    backend: str
    local: LinkDesc
    remote: Optional[LinkDesc]
    tier: int
    extra_latency: float = 0.0
    bw_factor: float = 1.0  # path-level derating (e.g. cross-NUMA UPI hop)


class TransportBackend:
    name = "abstract"
    link_class: LinkClass = LinkClass.TCP

    def __init__(self, topology: Topology):
        self.topo = topology
        self.spec = topology.spec

    def feasible(self, src: Location, dst: Location) -> bool:
        raise NotImplementedError

    def paths(self, src: Location, dst: Location) -> List[WirePath]:
        raise NotImplementedError

    # Nominal aggregate bandwidth for route ranking.
    def rank_bandwidth(self, src: Location, dst: Location) -> float:
        ps = self.paths(src, dst)
        return sum(p.local.bandwidth for p in ps if p.tier <= 2)

    def _src_numa(self, src: Location) -> int:
        if src.kind == MemoryKind.DEVICE_HBM:
            return self.spec.node.gpu_numa(src.device)
        return src.numa


class RdmaBackend(TransportBackend):
    """Multi-rail RDMA. With GPUDirect, HBM endpoints are directly reachable;
    otherwise only host memory is (the orchestrator then stages via PCIe)."""

    name = "rdma"
    link_class = LinkClass.RDMA

    def _endpoint_ok(self, loc: Location) -> bool:
        if loc.kind == MemoryKind.HOST_DRAM:
            return True
        return loc.kind == MemoryKind.DEVICE_HBM and self.spec.has_gpudirect

    def feasible(self, src: Location, dst: Location) -> bool:
        return self._endpoint_ok(src) and self._endpoint_ok(dst) and src.node != dst.node

    def paths(self, src: Location, dst: Location) -> List[WirePath]:
        out: List[WirePath] = []
        src_numa = self._src_numa(src)
        for nic in self.topo.rdma_nics(src.node):
            tier = self.topo.nic_tier(src, nic)
            remote = self.topo.remote_nic_for(dst, nic)
            cross = nic.numa != src_numa
            extra = self.spec.cross_numa_latency if cross else 0.0
            bwf = self.spec.cross_numa_bw_factor if cross else 1.0
            out.append(WirePath(self.name, nic, remote, tier, extra, bwf))
        return out


class NvlinkBackend(TransportBackend):
    name = "nvlink"
    link_class = LinkClass.NVLINK

    def feasible(self, src: Location, dst: Location) -> bool:
        return (
            self.spec.has_nvlink
            and src.kind == MemoryKind.DEVICE_HBM
            and dst.kind == MemoryKind.DEVICE_HBM
            and src.node == dst.node
            and src.device != dst.device
        )

    def paths(self, src: Location, dst: Location) -> List[WirePath]:
        a = self.topo.nvlink(src.node, src.device)
        b = self.topo.nvlink(dst.node, dst.device)
        if a is None or b is None:
            return []
        return [WirePath(self.name, a, b, 1)]


class MnnvlBackend(TransportBackend):
    """Rack-scale Multi-Node NVLink: GPU-to-GPU only, no host paths (§2.1)."""

    name = "mnnvl"
    link_class = LinkClass.MNNVL

    def feasible(self, src: Location, dst: Location) -> bool:
        return (
            self.spec.has_mnnvl
            and src.kind == MemoryKind.DEVICE_HBM
            and dst.kind == MemoryKind.DEVICE_HBM
            and (src.node, src.device) != (dst.node, dst.device)
        )

    def paths(self, src: Location, dst: Location) -> List[WirePath]:
        a = self.topo.mnnvl(src.node, src.device)
        b = self.topo.mnnvl(dst.node, dst.device)
        if a is None or b is None:
            return []
        return [WirePath(self.name, a, b, 1)]


class UbBackend(TransportBackend):
    """Ascend unified-bus fabric (portability target, Table 4)."""

    name = "ub"
    link_class = LinkClass.UB

    def feasible(self, src: Location, dst: Location) -> bool:
        return (
            self.spec.has_ub
            and src.kind == MemoryKind.DEVICE_HBM
            and dst.kind == MemoryKind.DEVICE_HBM
            and (src.node, src.device) != (dst.node, dst.device)
        )

    def paths(self, src: Location, dst: Location) -> List[WirePath]:
        a = self.topo.ub(src.node, src.device)
        b = self.topo.ub(dst.node, dst.device)
        if a is None or b is None:
            return []
        return [WirePath(self.name, a, b, 1)]


class PcieBackend(TransportBackend):
    """Host<->device copies within a node (the D2H/H2D hops of staged routes)."""

    name = "pcie"
    link_class = LinkClass.PCIE

    def feasible(self, src: Location, dst: Location) -> bool:
        kinds = {src.kind, dst.kind}
        return (
            src.node == dst.node
            and kinds == {MemoryKind.HOST_DRAM, MemoryKind.DEVICE_HBM}
        )

    def paths(self, src: Location, dst: Location) -> List[WirePath]:
        gpu_loc = src if src.kind == MemoryKind.DEVICE_HBM else dst
        host_loc = dst if src.kind == MemoryKind.DEVICE_HBM else src
        link = self.topo.pcie(gpu_loc.node, gpu_loc.device)
        tier = 1 if self.spec.node.gpu_numa(gpu_loc.device) == host_loc.numa else 2
        return [WirePath(self.name, link, None, tier)]


class ShmBackend(TransportBackend):
    name = "shm"
    link_class = LinkClass.SHM

    def feasible(self, src: Location, dst: Location) -> bool:
        return (
            src.node == dst.node
            and src.kind == MemoryKind.HOST_DRAM
            and dst.kind == MemoryKind.HOST_DRAM
        )

    def paths(self, src: Location, dst: Location) -> List[WirePath]:
        return [WirePath(self.name, self.topo.shm(src.node), None, 1)]


class TcpBackend(TransportBackend):
    """Legacy fallback: host-to-host over the datacenter network."""

    name = "tcp"
    link_class = LinkClass.TCP

    def feasible(self, src: Location, dst: Location) -> bool:
        return (
            src.node != dst.node
            and src.kind == MemoryKind.HOST_DRAM
            and dst.kind == MemoryKind.HOST_DRAM
        )

    def paths(self, src: Location, dst: Location) -> List[WirePath]:
        return [
            WirePath(self.name, self.topo.tcp(src.node), self.topo.tcp(dst.node), 2)
        ]


class FileBackend(TransportBackend):
    """io_uring-style storage lanes. Host<->file on the same node; GPU<->file
    directly when GPUDirect Storage is available (Table 4's GPU->File row)."""

    name = "file"
    link_class = LinkClass.STORAGE

    def feasible(self, src: Location, dst: Location) -> bool:
        kinds = (src.kind, dst.kind)
        if src.node != dst.node or MemoryKind.FILE not in kinds:
            return False
        other = dst.kind if src.kind == MemoryKind.FILE else src.kind
        if other == MemoryKind.HOST_DRAM:
            return True
        return other == MemoryKind.DEVICE_HBM and self.spec.has_gpudirect

    def paths(self, src: Location, dst: Location) -> List[WirePath]:
        return [WirePath(self.name, self.topo.storage(src.node), None, 1)]


ALL_BACKENDS = [
    RdmaBackend,
    NvlinkBackend,
    MnnvlBackend,
    UbBackend,
    PcieBackend,
    ShmBackend,
    TcpBackend,
    FileBackend,
]


def load_backends(topology: Topology) -> dict:
    """Dynamic backend registry (the paper loads these as plugins)."""
    return {cls.name: cls(topology) for cls in ALL_BACKENDS}
