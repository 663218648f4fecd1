"""The port's TENT engine against the reference's, bit for bit.

The reference engine comes from `ScenarioRunner.build_engine` for the
`disagg_prefill_decode` scenario (slow two-node fabric, one tier-1 rail
flapping over [0.02, 0.05) s); the port's is built by hand from the same
values. Both run the same GPU-to-GPU transfers across the flap.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import Location as RefLocation
from repro.core import MemoryKind as RefKind
from repro.scenarios import ScenarioRunner, get
from repro_torch.core import (
    EngineConfig,
    FabricSpec,
    HealthConfig,
    Location,
    MemoryKind,
    NodeSpec,
    TentEngine,
)

SCENARIO = "disagg_prefill_decode"


def _port_engine(spec) -> TentEngine:
    topo, ep = spec.topology, spec.engine
    fabric = FabricSpec(
        n_nodes=topo.n_nodes,
        node=NodeSpec(n_numa=topo.n_numa, n_gpus=topo.n_gpus, n_nics=topo.n_nics),
        nic_bw=topo.nic_bw, tcp_bw=topo.tcp_bw, has_nvlink=topo.has_nvlink,
        has_gpudirect=topo.has_gpudirect, has_mnnvl=topo.has_mnnvl, has_ub=topo.has_ub)
    config = EngineConfig(
        policy="tent", slice_bytes=ep.slice_bytes, max_slices=ep.max_slices,
        max_inflight=ep.max_inflight, gamma=ep.gamma, reset_interval=ep.reset_interval,
        wave=ep.wave, candidate_cache=ep.candidate_cache, wave_complete=ep.wave_complete,
        wave_min=ep.wave_min, jit_core=ep.jit_core, calendar_queue=ep.calendar_queue,
        health=HealthConfig(probe_interval=ep.probe_interval, retry_limit=ep.retry_limit))
    eng = TentEngine(fabric, config=config, seed=spec.seed)
    for f in spec.faults:
        link = eng.topology.rdma_nic(f.node, f.nic)
        eng.fabric.schedule_failure(link.link_id, at=f.at, recover_at=f.until)
    return eng


def _drive(eng, loc_cls, kind, sizes, seed):
    """Submit one batch per GPU pair (node 0 GPU i -> node 1 GPU i) with
    seeded payloads, drain the fabric, and return what the run shows."""
    rng = np.random.default_rng(seed)
    node = eng.topology.spec.node
    results, payloads = [], []
    for i, nbytes in enumerate(sizes):
        gpu = i % node.n_gpus
        src = eng.register_segment(
            loc_cls(node=0, kind=kind, device=gpu, numa=node.gpu_numa(gpu)), nbytes)
        dst = eng.register_segment(
            loc_cls(node=1, kind=kind, device=gpu, numa=node.gpu_numa(gpu)), nbytes)
        data = rng.integers(0, 256, nbytes, dtype=np.uint8)
        src.write(0, data)
        batch = eng.allocate_batch()
        eng.submit_transfer(batch, [(src.segment_id, 0, dst.segment_id, 0, nbytes)])
        eng.on_batch_done(batch, results.append)
        payloads.append((dst, data))
    eng.run_until_idle()
    intact = all(np.array_equal(dst.read(0, d.size), d) for dst, d in payloads)
    first = min(r.batch_id for r in results)
    rows = [dataclasses.replace(r, batch_id=r.batch_id - first) for r in results]
    return {
        "results": [dataclasses.astuple(r) for r in rows],
        "now": eng.fabric.now,
        "waves": eng.waves,
        "slices_issued": eng.slices_issued,
        "slices_retried": eng.slices_retried,
        "intact": intact,
    }


@pytest.mark.parametrize("sizes", [
    (96 << 20, 32 << 20, 64 << 20, 48 << 20),  # four GPU pairs across the flap
    (103_809_024,),  # one elephant: the full-width f32 KV cache of chip_smoke
])
def test_engine_bit_identical_across_flap(sizes):
    spec = get(SCENARIO)
    ref_eng, _ = ScenarioRunner(spec).build_engine("tent")
    ref = _drive(ref_eng, RefLocation, RefKind.DEVICE_HBM, sizes, seed=3)
    port = _drive(_port_engine(spec), Location, MemoryKind.DEVICE_HBM, sizes, seed=3)
    assert port == ref
    assert ref["intact"] and all(r[1] for r in ref["results"])
    # the flap really overlapped the flows: slices were retried around it
    assert ref["slices_retried"] > 0


def test_jit_core_is_refused(monkeypatch):
    """jit_core runs on the engine's device, CUDA unless the caller asks for
    the CPU: without a card it is refused, never run quietly on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TentEngine(FabricSpec(), config=EngineConfig(jit_core=True))
    eng = TentEngine(FabricSpec(), config=EngineConfig(jit_core=True), device="cpu")
    assert eng._jit is not None and eng._jit.device.type == "cpu"
