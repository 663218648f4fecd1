"""The `spray_sim` kernel's binding (`repro_torch.kernels.spray_sim.kernel`)
on the CPU.

The kernel itself runs only on the card, where `chip_smoke.py` (phase
mc_sweep) holds every lane against the plain sim and the numpy twin. Here
the binding's own decisions are pinned: the launch plan (threads a lane,
windows in registers or shared memory, lanes a block, shared memory a
lane) admits every sweepable program of the library and refuses, before
anything is built or launched, a program whose lane does not fit a block;
and with the library replaced by a recording stub, the wrapper hands the
kernel the draws in their lane-major layout (no transposed copy) with the
program's sizes and the policy, and counts one launch.
"""
import contextlib
import dataclasses
import math

import pytest
import torch

from repro_torch.core import jit_core
from repro_torch.kernels.spray_sim import kernel
from repro_torch.scenarios import get
from repro_torch.scenarios.sweep import compile_spray_program, sweepable_names


@pytest.fixture(scope="module")
def programs():
    return {name: compile_spray_program(get(name)) for name in sweepable_names()}


def _sizes(p):
    return (p.n_rails, p.rounds, p.wave, p.fail_start.shape[1], p.degs_start.shape[1],
            p.degd_start.shape[1])


@pytest.mark.parametrize("n_lanes", [1, 64, 4096])
def test_the_plan_admits_every_sweepable_program(programs, n_lanes):
    assert len(programs) == 13
    for name, p in programs.items():
        plan = kernel.plan_for(p, n_lanes)
        D, R, W, Kf, Ks, Kd = _sizes(p)
        assert plan.G == 16 and plan.rails_per_thread == 1, name
        assert plan.smem_per_block <= kernel.SMEM_PER_BLOCK, name
        assert plan.threads_per_block <= kernel.MAX_BLOCK, name
        assert plan.groups_per_block * plan.blocks >= n_lanes > plan.groups_per_block * (
            plan.blocks - 1), name
        in_regs = plan.fault_cap > 0
        assert in_regs == (plan.degrade_cap > 0), name
        if in_regs:
            assert Kf <= plan.fault_cap and max(Ks, Kd) <= plan.degrade_cap, name
        assert plan.group_bytes == kernel.group_smem_bytes(D, W, Kf, Ks, Kd, not in_regs)
    # the 73-window tenant program keeps its windows in shared memory
    tenant = kernel.plan_for(programs["multi_tenant_contention"], 64)
    assert (tenant.fault_cap, tenant.degrade_cap) == (0, 0)
    assert kernel.plan_for(programs["flap_storm"], 64).fault_cap == 8


def test_a_64_lane_sweep_spreads_over_many_sms(programs):
    # a lane a block (so a warp to itself) on 64 SMs
    plan = kernel.plan_for(programs["single_rail_flap"], 64, n_sms=132)
    assert plan.blocks == 64 and plan.threads_per_block == 16
    # many lanes a SM: packed, two lanes a warp, eight warps a block
    plan = kernel.plan_for(programs["flap_storm"], 4096, n_sms=132)
    assert plan.groups_per_block == 16 and plan.threads_per_block == 256
    assert plan.blocks == 256
    # the 73-window tenant program: as many lanes as its shared memory holds
    tenant = kernel.plan_for(programs["multi_tenant_contention"], 4096, n_sms=132)
    assert tenant.groups_per_block == kernel.SMEM_PER_BLOCK // tenant.group_bytes


def test_group_shared_memory_layout():
    # 56 bytes a slice (the multipliers twice, the record and its list
    # link), the windows when they are not in registers; 16-aligned
    assert kernel.group_smem_bytes(8, 64, 2, 1, 1, False) == 56 * 64
    assert kernel.group_smem_bytes(8, 3, 2, 1, 1, False) == 176
    assert kernel.group_smem_bytes(8, 256, 2, 73, 73, True) == 56 * 256 + 24 * 8 * 148


def test_wider_programs_take_a_warp_a_lane():
    assert kernel.launch_plan(4, 20, 2, 8, 2, 1, 1).G == 32
    plan = kernel.launch_plan(4, 40, 2, 8, 2, 1, 1)
    assert (plan.G, plan.rails_per_thread, plan.fault_cap) == (32, 2, 0)
    with pytest.raises(ValueError, match="rails"):
        kernel.launch_plan(4, kernel.MAX_RAILS + 1, 2, 8, 2, 1, 1)


class _StubLib:
    """Records each launch's arguments in place of the built library."""

    def __init__(self):
        self.calls = []

    def spray_sim_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub_card(monkeypatch):
    """The binding on CPU tensors, with the library replaced by a stub."""
    lib = _StubLib()
    monkeypatch.setattr(kernel, "load", lambda: lib)
    monkeypatch.setattr(kernel, "_on_card", lambda t: True)
    monkeypatch.setattr(kernel, "_device_guard", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(kernel, "_stream", lambda dev: 7)
    monkeypatch.setattr(kernel, "_n_sms", lambda dev: 132)
    monkeypatch.setattr(kernel, "launches", 0)
    return lib


def _draw_tensors(p, n):
    draws = jit_core.stack_draws(p, n, base_seed=0)
    return [torch.from_numpy(draws[k]) for k in ("uf", "us", "ud", "jm")]


@pytest.mark.parametrize("name,policy,fault_jitter", [
    ("single_rail_flap", "tent", 0.25), ("flap_storm", "round_robin", 0.0),
    ("multi_tenant_contention", "tent", 0.25), ("disagg_prefill_decode", "round_robin", 0.25)])
def test_the_wrapper_hands_the_kernel_lane_major_draws(programs, stub_card, name, policy,
                                                       fault_jitter):
    p = programs[name]
    uf, us, ud, jm = _draw_tensors(p, 3)
    out = kernel.spray_sim(p, uf, us, ud, jm, round_robin=policy == "round_robin",
                           fault_jitter=fault_jitter)
    assert kernel.launches == 1 and len(stub_card.calls) == 1
    assert tuple(out.shape) == (3, 5) and out.dtype == torch.float64
    args = stub_card.calls[0]
    # the draws' own storage, in the layout make_draws stacks: no copy
    assert args[1:5] == tuple(t.data_ptr() for t in (uf, us, ud, jm))
    assert args[5] == out.data_ptr()
    D, R, W, Kf, Ks, Kd = _sizes(p)
    assert args[6:14] == (3, D, R, W, Kf, Ks, Kd, int(policy == "round_robin"))
    inv = math.inf if fault_jitter == 0 else 1.0 / fault_jitter
    assert args[14:18] == (float(p.length), float(p.detect), float(p.gamma), inv)
    plan = kernel.plan_for(p, 3)
    assert args[18:23] == (plan.G, plan.fault_cap, plan.degrade_cap, plan.groups_per_block,
                           plan.group_bytes)
    assert args[23] == 7  # the current stream
    prog = kernel.program_constants(p)
    assert prog.size == 9 * (D + 1) + 2 * D * Kf + 3 * D * (Ks + Kd)


def test_a_program_that_cannot_fit_is_refused_before_any_launch(programs, stub_card):
    p = dataclasses.replace(programs["single_rail_flap"], rounds=1, wave=100_000)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.launch_plan(1, *_sizes(p))
    uf, us, ud, jm = _draw_tensors(p, 1)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.spray_sim(p, uf, us, ud, jm, round_robin=False, fault_jitter=0.25)
    assert kernel.launches == 0 and not stub_card.calls


def test_the_wrapper_refuses_draws_it_cannot_read(programs, stub_card):
    p = programs["single_rail_flap"]
    uf, us, ud, jm = _draw_tensors(p, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.spray_sim(p, uf, us, ud, jm.transpose(1, 2).contiguous().transpose(1, 2),
                         round_robin=False, fault_jitter=0.25)
    with pytest.raises(ValueError, match="shape"):
        kernel.spray_sim(p, uf, us, ud, jm[:, :-1], round_robin=False, fault_jitter=0.25)
    with pytest.raises(ValueError, match="float64"):
        kernel.spray_sim(p, uf, us, ud, jm.float(), round_robin=False, fault_jitter=0.25)
    assert kernel.launches == 0 and not stub_card.calls
