"""The port's Monte Carlo sweep (`repro_torch.scenarios.sweep`) on the CPU.

With `device="cpu"` a sweep runs the plain lane-batched torch sim, the
plain version of the `spray_sim` kernel (held against it on the card by
`chip_smoke.py`, phase mc_sweep). Each lane must equal the reference's
numpy twin `repro.core.jit_core.simulate_spray_ref` bit for bit on the
port's draws, handed over as numpy (the reference's own draws come from
jax's PRNG, which the port does not use). The sweep's determinism, its
distribution gates and its compile rejections are pinned as the
reference's tests/test_mc_sweep.py pins them.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.scenarios as ref
import repro.scenarios.sweep as ref_sweep
from repro.core.jit_core import simulate_spray_ref as ref_simulate
from repro_torch.core import jit_core
from repro_torch.kernels.spray_sim import spray_sim_ref
from repro_torch.scenarios import MonteCarloSweep, get
from repro_torch.scenarios.sweep import compile_spray_program, sweepable_names

FLAP = "single_rail_flap"


@pytest.fixture(scope="module")
def flap_sweep_64():
    """One 64-seed sweep of the flap on the CPU, shared by the checks."""
    return MonteCarloSweep(get(FLAP), n_seeds=64, fault_jitter=0.25, device="cpu").run()


@pytest.fixture(scope="module")
def flap_program():
    return compile_spray_program(get(FLAP))


def test_program_equals_the_reference_program(flap_program):
    want = ref_sweep.compile_spray_program(ref.get(FLAP))
    for field in dataclasses.fields(want):
        a, b = getattr(want, field.name), getattr(flap_program, field.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), field.name


def _ref_lanes(p, draws, policy, fault_jitter, n):
    return [ref_simulate(p, {k: v[i] for k, v in draws.items()}, policy=policy,
                         fault_jitter=fault_jitter) for i in range(n)]


@pytest.mark.parametrize("policy", ["tent", "round_robin"])
def test_lanes_equal_the_reference_numpy_twin(flap_program, flap_sweep_64, policy):
    """Seeds 0-2 of the flap, fault_jitter 0 (the plain sim here) and 0.25
    (the 64-seed sweep's lanes): each lane equals the reference's numpy twin
    on the port's draws, bit for bit."""
    p = flap_program
    draws = jit_core.stack_draws(p, 3, base_seed=get(FLAP).seed)
    got = spray_sim_ref(p, draws, policy=policy, fault_jitter=0.0).numpy()
    assert [tuple(row) for row in got.tolist()] == _ref_lanes(p, draws, policy, 0.0, 3)
    dist = flap_sweep_64.policies[policy]
    for i, (thr, heal_s, bytes_ok, lost, mk) in enumerate(
            _ref_lanes(p, draws, policy, 0.25, 3)):
        assert (dist.throughput[i], dist.bytes_ok[i], dist.lost[i], dist.makespan[i]) == (
            thr, bytes_ok, lost, mk), (policy, i)
        assert dist.healing_ms[i] == (-1.0 if heal_s < 0 else min(heal_s * 1e3, 1e9))


def test_port_numpy_twin_equals_the_reference(flap_program):
    p = flap_program
    lane = jit_core.make_draws(p, base_seed=get(FLAP).seed, seed_index=1)
    assert jit_core.simulate_spray_ref(p, lane, policy="tent", fault_jitter=0.25) == \
        ref_simulate(p, lane, policy="tent", fault_jitter=0.25)


def test_draws_depend_only_on_the_seed(flap_program):
    p = flap_program
    one = jit_core.make_draws(p, base_seed=0, seed_index=5)
    many = jit_core.stack_draws(p, 8, base_seed=0)
    for key, shape in (("uf", p.fail_start.shape + (2,)), ("us", p.degs_start.shape + (3,)),
                       ("ud", p.degd_start.shape + (3,)), ("jm", (p.rounds, p.wave, 2))):
        assert one[key].shape == shape and one[key].dtype == np.float64
        assert np.array_equal(one[key], many[key][5])
    assert (np.abs(one["uf"]) <= 1.0).all() and (one["jm"] >= 1.0).all()
    assert not np.array_equal(one["jm"], jit_core.make_draws(p, base_seed=1,
                                                             seed_index=5)["jm"])


def test_repeat_run_is_byte_identical(flap_sweep_64):
    again = MonteCarloSweep(get(FLAP), n_seeds=64, fault_jitter=0.25, device="cpu").run()
    assert again.to_json(sort_keys=True) == flap_sweep_64.to_json(sort_keys=True)


@pytest.mark.parametrize("policy", ["tent", "round_robin"])
def test_a_lane_equals_a_single_seed_run(flap_sweep_64, policy):
    sweep = MonteCarloSweep(get(FLAP), n_seeds=64, fault_jitter=0.25, device="cpu")
    dist = flap_sweep_64.policies[policy]
    i = 5
    thr, heal_s, bytes_ok, lost, mk = sweep.run_single(i, policy=policy)
    assert (dist.throughput[i], dist.makespan[i], dist.bytes_ok[i], dist.lost[i]) == (
        thr, mk, bytes_ok, lost)
    assert dist.healing_ms[i] == (-1.0 if heal_s < 0 else min(heal_s * 1e3, 1e9))


def test_flap_healing_tail_is_sub_50ms_over_64_seeds(flap_sweep_64):
    tent = flap_sweep_64.policies["tent"]
    assert flap_sweep_64.n_seeds == 64
    p999 = tent.summary["healing_p999_ms"]
    assert 0.0 < p999 < 50.0
    heal = np.asarray(tent.healing_ms)
    assert (heal >= 0.0).all() and (heal < 1e9).all()
    assert tent.summary["healing_p999_ci_lo"] <= p999 <= tent.summary["healing_p999_ci_hi"]


def test_declared_expectations_pass_on_the_flap(flap_sweep_64):
    assert flap_sweep_64.ok, flap_sweep_64.violations


@pytest.mark.parametrize("field,value,words", [("healing_p999_ms", 1e-6, "healing P99.9"),
                                               ("throughput_p50_vs_baseline", 100.0,
                                                "throughput P50")])
def test_violated_expectations_surface(field, value, words):
    spec = get(FLAP)
    strict = dataclasses.replace(
        spec, expectations=dataclasses.replace(spec.expectations, **{field: value}))
    rep = MonteCarloSweep(strict, n_seeds=4, fault_jitter=0.25, rounds=24, device="cpu").run()
    assert not rep.ok
    assert any(words in v for v in rep.violations)


def test_scenario_report_projection(flap_sweep_64):
    doc = flap_sweep_64.to_scenario_report().to_dict()
    assert doc["scenario"] == f"{FLAP}::mc"
    assert list(doc["policies"]) == list(get(FLAP).policies)
    tent = doc["policies"]["tent"]
    summary = flap_sweep_64.policies["tent"].summary
    assert tent["throughput"] == summary["throughput_p50"]
    assert tent["recovery_ms"] == summary["healing_p50_ms"]
    assert tent["stall_ms"] == summary["healing_p999_ms"]
    assert doc["spec"]["mc"]["n_seeds"] == 64


def test_sweepable_names_match_the_reference():
    assert sweepable_names() == ref_sweep.sweepable_names()
    assert FLAP in sweepable_names() and "flap_storm" in sweepable_names()


def test_compile_rejections_match_the_reference():
    non = [n for n in ref.names() if n not in ref_sweep.sweepable_names()]
    assert non
    for name in non:
        with pytest.raises(ValueError) as want:
            ref_sweep.compile_spray_program(ref.get(name))
        with pytest.raises(ValueError) as got:
            compile_spray_program(get(name))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="none of"):
        MonteCarloSweep(get(FLAP), policies=["random"], device="cpu")
    with pytest.raises(ValueError, match="n_seeds"):
        MonteCarloSweep(get(FLAP), n_seeds=0, device="cpu")


def test_no_card_means_no_sweep(monkeypatch, flap_program):
    """device None means CUDA for every sweep entry point, the kernel's
    public wrapper included: without a card each refuses, none quietly runs
    the plain sim on the host."""
    from repro_torch.kernels.spray_sim import spray_sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    draws = jit_core.stack_draws(flap_program, 2, base_seed=0)
    for call in (lambda: spray_sim(flap_program, draws),
                 lambda: jit_core.spray_sweep(flap_program, 2),
                 lambda: jit_core.spray_single(flap_program),
                 lambda: MonteCarloSweep(get(FLAP), n_seeds=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    got = spray_sim(flap_program, draws, device="cpu")
    assert got.device.type == "cpu" and tuple(got.shape) == (2, 5)


def test_a_sweep_draws_once_for_all_its_policies(monkeypatch):
    """`MonteCarloSweep.run` draws the seeds once and hands the same draws
    to each policy: its report is byte-equal to one drawn per policy (the
    `spray_sweep` entry point, which draws on each call)."""
    import repro_torch.scenarios.sweep as port_sweep

    sweep = MonteCarloSweep(get(FLAP), n_seeds=6, fault_jitter=0.25, rounds=24, device="cpu")
    calls = []
    real = port_sweep.stack_draws

    def counted(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_sweep, "stack_draws", counted)
    rep = sweep.run()
    assert calls == [6] and len(sweep.policies) == 2
    per_policy = {pol: port_sweep._summarize(
        pol, jit_core.spray_sweep(sweep.program, 6, base_seed=sweep.base_seed, policy=pol,
                                  fault_jitter=0.25, device="cpu"), sweep.base_seed)
        for pol in sweep.policies}
    want = port_sweep.SweepReport(
        scenario=FLAP, n_seeds=6, base_seed=sweep.base_seed, fault_jitter=0.25, rounds=24,
        wave=sweep.program.wave, policies=per_policy,
        violations=tuple(sweep._violations(per_policy)), spec=get(FLAP).to_dict())
    assert rep.to_json(sort_keys=True) == want.to_json(sort_keys=True)
