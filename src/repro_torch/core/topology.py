"""Tiered topology discovery and reachability map (paper §3.1).

At initialization TENT enumerates NICs, GPUs, storage devices and their
interconnects, classifying links into protocol-independent affinity tiers:

  tier-1  optimal paths (NVLink, GPUDirect-affine NIC, same-NUMA rail)
  tier-2  cross-root connections (same NUMA node, different PCIe root)
  tier-3  NUMA-crossing fallbacks

The resulting tiered topology graph is the global ground truth for routing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .types import LinkClass, Location, MemoryKind

# Paper §4.2: P_tier = {1, 3, inf} for tiers 1..3.
DEFAULT_TIER_PENALTY: Dict[int, float] = {1: 1.0, 2: 3.0, 3: float("inf")}


@dataclasses.dataclass(frozen=True)
class LinkDesc:
    """Static description of one physical link (a schedulable 'device')."""

    link_id: int
    node: int
    link_class: LinkClass
    index: int  # NIC ordinal / GPU ordinal within the node
    numa: int
    bandwidth: float  # bytes/sec, nominal (telemetry corrects the truth)
    base_latency: float  # seconds

    @property
    def name(self) -> str:
        return f"n{self.node}/{self.link_class.value}{self.index}"


@dataclasses.dataclass
class NodeSpec:
    """One server. Defaults mirror the paper's H800 HGX testbed:
    8 GPUs + 8 x 200 Gbps NICs over two NUMA domains, NVLink intra-node."""

    n_numa: int = 2
    n_gpus: int = 8
    n_nics: int = 8

    def gpu_numa(self, gpu: int) -> int:
        return gpu * self.n_numa // max(self.n_gpus, 1)

    def nic_numa(self, nic: int) -> int:
        return nic * self.n_numa // max(self.n_nics, 1)

    def tier1_nic(self, gpu: int) -> int:
        """The NIC sharing the GPU's PCIe root complex (1:1 affinity)."""
        return gpu * self.n_nics // max(self.n_gpus, 1)


@dataclasses.dataclass
class FabricSpec:
    """Cluster description. Bandwidth constants follow the paper's testbed
    (8-rail 200 Gbps RoCE = 25 GB/s/NIC; NVLink 204.5 GB/s; io_uring 6 GB/s;
    MNNVL 956.2 GB/s; Ascend UB 196 GB/s)."""

    n_nodes: int = 2
    node: NodeSpec = dataclasses.field(default_factory=NodeSpec)
    nic_bw: float = 25.0e9
    nvlink_bw: float = 204.5e9
    mnnvl_bw: float = 956.2e9
    ub_bw: float = 196.0e9
    pcie_bw: float = 27.0e9
    shm_bw: float = 20.0e9
    tcp_bw: float = 3.0e9
    storage_bw: float = 6.0e9
    rdma_latency: float = 5e-6
    nvlink_latency: float = 1.5e-6
    pcie_latency: float = 3e-6
    tcp_latency: float = 40e-6
    shm_latency: float = 1e-6
    storage_latency: float = 80e-6
    # capability switches (portability matrix, paper §5.2)
    has_nvlink: bool = True
    has_gpudirect: bool = True
    has_mnnvl: bool = False
    has_ub: bool = False
    # submission-side NUMA crossing cost (paper §2.2: rails physically
    # distant from submission threads exhibit higher per-slice service time)
    cross_numa_latency: float = 30e-6
    cross_numa_bw_factor: float = 0.45


class Topology:
    """Materialized link graph + tier classification + reachability."""

    def __init__(self, spec: FabricSpec):
        self.spec = spec
        self.links: List[LinkDesc] = []
        self._rdma: Dict[Tuple[int, int], LinkDesc] = {}  # (node, nic)
        self._nvlink: Dict[Tuple[int, int], LinkDesc] = {}  # (node, gpu)
        self._mnnvl: Dict[Tuple[int, int], LinkDesc] = {}
        self._ub: Dict[Tuple[int, int], LinkDesc] = {}
        self._pcie: Dict[Tuple[int, int], LinkDesc] = {}
        self._shm: Dict[int, LinkDesc] = {}  # node
        self._tcp: Dict[int, LinkDesc] = {}
        self._storage: Dict[int, LinkDesc] = {}
        self._build()

    # -- discovery ---------------------------------------------------------
    def _add(self, node: int, cls: LinkClass, index: int, numa: int, bw: float, lat: float) -> LinkDesc:
        link = LinkDesc(
            link_id=len(self.links), node=node, link_class=cls, index=index,
            numa=numa, bandwidth=bw, base_latency=lat,
        )
        self.links.append(link)
        return link

    def _build(self) -> None:
        s = self.spec
        for n in range(s.n_nodes):
            for nic in range(s.node.n_nics):
                self._rdma[(n, nic)] = self._add(
                    n, LinkClass.RDMA, nic, s.node.nic_numa(nic), s.nic_bw, s.rdma_latency)
            for gpu in range(s.node.n_gpus):
                numa = s.node.gpu_numa(gpu)
                if s.has_nvlink:
                    self._nvlink[(n, gpu)] = self._add(
                        n, LinkClass.NVLINK, gpu, numa, s.nvlink_bw, s.nvlink_latency)
                if s.has_mnnvl:
                    self._mnnvl[(n, gpu)] = self._add(
                        n, LinkClass.MNNVL, gpu, numa, s.mnnvl_bw, s.nvlink_latency)
                if s.has_ub:
                    self._ub[(n, gpu)] = self._add(
                        n, LinkClass.UB, gpu, numa, s.ub_bw, s.nvlink_latency)
                self._pcie[(n, gpu)] = self._add(
                    n, LinkClass.PCIE, gpu, numa, s.pcie_bw, s.pcie_latency)
            self._shm[n] = self._add(n, LinkClass.SHM, 0, 0, s.shm_bw, s.shm_latency)
            self._tcp[n] = self._add(n, LinkClass.TCP, 0, 0, s.tcp_bw, s.tcp_latency)
            self._storage[n] = self._add(n, LinkClass.STORAGE, 0, 0, s.storage_bw, s.storage_latency)

    # -- accessors ----------------------------------------------------------
    def rdma_nics(self, node: int) -> List[LinkDesc]:
        return [self._rdma[(node, i)] for i in range(self.spec.node.n_nics)]

    def rdma_nic(self, node: int, nic: int) -> LinkDesc:
        return self._rdma[(node, nic)]

    def nvlink(self, node: int, gpu: int) -> Optional[LinkDesc]:
        return self._nvlink.get((node, gpu))

    def mnnvl(self, node: int, gpu: int) -> Optional[LinkDesc]:
        return self._mnnvl.get((node, gpu))

    def ub(self, node: int, gpu: int) -> Optional[LinkDesc]:
        return self._ub.get((node, gpu))

    def pcie(self, node: int, gpu: int) -> LinkDesc:
        return self._pcie[(node, gpu)]

    def shm(self, node: int) -> LinkDesc:
        return self._shm[node]

    def tcp(self, node: int) -> LinkDesc:
        return self._tcp[node]

    def storage(self, node: int) -> LinkDesc:
        return self._storage[node]

    # -- tier classification (paper §3.1 + §5.1.3) ---------------------------
    def nic_tier(self, src: Location, nic: LinkDesc) -> int:
        """Affinity tier of a local NIC with respect to a source location.

        DEVICE_HBM: tier-1 = the GPU's PCIe-root NIC; tier-2 = same-NUMA;
                    tier-3 = NUMA-crossing (penalty inf by default).
        HOST_DRAM:  tier-1 = same-NUMA NIC; tier-2 = cross-NUMA (hosts can
                    reach any NIC through the interconnect, at a cost).
        FILE:       all NICs tier-2 (data is staged through host anyway).
        """
        if src.kind == MemoryKind.DEVICE_HBM:
            if nic.index == self.spec.node.tier1_nic(src.device):
                return 1
            if nic.numa == self.spec.node.gpu_numa(src.device):
                return 2
            return 3
        if src.kind == MemoryKind.HOST_DRAM:
            return 1 if nic.numa == src.numa else 2
        return 2

    def remote_nic_for(self, dst: Location, local_nic: LinkDesc) -> LinkDesc:
        """Topology-aligned 1:1 remote endpoint mapping (paper §4.2):
        prefer the remote NIC sharing the destination buffer's root/NUMA and
        the same ordinal; the engine falls back dynamically on failure."""
        node = dst.node
        want = local_nic.index
        cand = self._rdma.get((node, want))
        if cand is not None:
            return cand
        return self.rdma_nics(node)[0]

    def remote_nic_alternatives(self, dst: Location, exclude: Tuple[int, ...] = ()) -> List[LinkDesc]:
        out = [l for l in self.rdma_nics(dst.node) if l.index not in exclude]
        # Prefer NICs near the destination buffer
        dst_numa = dst.numa if dst.kind == MemoryKind.HOST_DRAM else self.spec.node.gpu_numa(dst.device)
        out.sort(key=lambda l: (l.numa != dst_numa, l.index))
        return out
