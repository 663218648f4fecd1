"""The port's jitted engine core (`EngineConfig.jit_core`) on the CPU.

With `device="cpu"` the adapter runs the kernels' plain versions, the torch
fp64 twins of the reference's `*_jnp` programs. They must equal the
reference's numpy paths (`repro.core.scheduler.tent_choose_wave`,
`TelemetryStore.on_complete_many`) bit for bit on seeded randomized inputs,
as the reference pins its jitted kernels (tests/test_jit_parity.py), and
the engine with the core on must give the reference's reports, also with
the crossover forced to 1. The packing of the card path (one staging
buffer, the layouts of csrc/tent_core.cu) is pinned here with the kernels
emulated by the twins; the kernels themselves run only on the card
(`chip_smoke.py`, phase jit_core). The library-wide toggle parity is in
`test_torch_scenario_toggles.py`.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.scenarios as ref
import repro_torch.core as port_core
import repro_torch.scenarios as port
from repro_torch.core import EngineConfig, FabricSpec, TentEngine, jit_core
from repro_torch.core.jit_core import EngineJitCore, _bucket
from repro_torch.core.scheduler import (
    __torch_twins__,
    tent_choose_torch,
    tent_choose_wave_padded_torch,
    tent_choose_wave_torch,
    tent_on_complete_many_torch,
    tent_scores_torch,
)
from repro_torch.kernels.tent_core import kernel as tc_kernel
from repro_torch.kernels.tent_core import ops as tc_ops

CPU = torch.device("cpu")


def _pad_choose_args(rng, n_c, n_s, all_excluded=False):
    """The reference's randomized chooser inputs (tests/test_jit_parity.py)."""
    q = rng.integers(0, 1 << 28, size=n_c)
    gl = rng.uniform(0.0, 1e7, size=n_c)
    gr = rng.uniform(0.0, 1e7, size=n_c)
    bw = rng.choice([1e9, 25e9, 100e9], size=n_c)
    b0 = rng.uniform(0.0, 1e-3, size=n_c)
    b1 = rng.uniform(0.05, 10.0, size=n_c)
    pen = rng.choice([1.0, 1.0, 1.5, np.inf], size=n_c)
    ex = np.ones(n_c, dtype=bool) if all_excluded else rng.random(n_c) < 0.35
    lengths = rng.integers(1, 1 << 20, size=n_s)
    return q, gl, gr, bw, b0, b1, pen, ex, lengths


def _padded(args):
    q, gl, gr, bw, b0, b1, pen, ex, lengths = args
    pc, ps = _bucket(len(q)), _bucket(len(lengths))

    def pad(a, n, fill):
        out = np.full(n, fill, dtype=np.float64)
        out[:len(a)] = a
        return out

    return (pad(q, pc, 0.0), pad(gl, pc, 0.0), pad(gr, pc, 0.0), pad(bw, pc, 1.0),
            pad(b0, pc, 0.0), pad(b1, pc, 1.0), pad(pen, pc, np.inf), pad(ex, pc, 1.0),
            pad(lengths, ps, 0.0), pad(np.ones(len(lengths)), ps, 0.0))


def _run_padded(args, rr, gamma):
    n_c, n_s = len(args[0]), len(args[8])
    c, qa, qo, rro = tent_choose_wave_padded_torch(
        *(torch.from_numpy(a) for a in _padded(args)), rr, gamma)
    return (c.numpy()[:n_s], qa.numpy()[:n_s].astype(np.int64),
            qo.numpy()[:n_c].astype(np.int64), int(rro))


def _same(want, got):
    return all(np.array_equal(np.asarray(w), np.asarray(g)) for w, g in zip(want, got))


def test_twin_registry_names_every_torch_twin():
    assert set(__torch_twins__) == {
        "tent_scores_torch", "tent_choose_torch", "tent_choose_wave_torch",
        "tent_on_complete_many_torch", "tent_choose_wave_padded_torch"}
    assert set(__torch_twins__) == {n.replace("_jnp", "_torch")
                                    for n in ref_core.scheduler.__numpy_twins__}


@pytest.mark.parametrize("case", range(6))
def test_padded_twin_equals_reference_numpy_chooser(case):
    rng = np.random.default_rng(29 + case)
    for _ in range(10):
        n_c, n_s = int(rng.integers(1, 11)), int(rng.integers(1, 50))
        args = _pad_choose_args(rng, n_c, n_s)
        rr, gamma = int(rng.integers(0, 1000)), float(rng.choice([0.0, 0.05, 0.2]))
        want = ref_core.tent_choose_wave(*args, rr, gamma=gamma)
        assert _same(want, _run_padded(args, rr, gamma))
        assert _same(want, port_core.tent_choose_wave(*args, rr, gamma=gamma))


def test_padded_twin_at_large_buckets():
    rng = np.random.default_rng(7)
    for n_c, n_s in ((30, 100), (200, 300), (700, 1000)):
        args = _pad_choose_args(rng, n_c, n_s)
        want = ref_core.tent_choose_wave(*args, 11, gamma=0.05)
        assert _same(want, _run_padded(args, 11, 0.05))


def test_unpadded_twin_equals_reference_numpy_chooser():
    rng = np.random.default_rng(5)
    for _ in range(10):
        args = _pad_choose_args(rng, int(rng.integers(1, 11)), int(rng.integers(1, 40)))
        want = ref_core.tent_choose_wave(*args, 3, gamma=0.05)
        c, qa, qo, rro = tent_choose_wave_torch(*(np.asarray(a) for a in args), 3, 0.05)
        if (want[0] < 0).any():  # the numpy kernel stops the wave at an infeasible slice
            continue
        assert _same(want, (c.numpy(), qa.numpy().astype(np.int64),
                            qo.numpy().astype(np.int64), int(rro)))


def test_all_excluded_fallback_matches_reference():
    rng = np.random.default_rng(31)
    for _ in range(20):
        args = _pad_choose_args(rng, int(rng.integers(2, 9)), 8, all_excluded=True)
        want = ref_core.tent_choose_wave(*args, 5, gamma=0.05)
        got = _run_padded(args, 5, 0.05)
        assert _same(want, got)
        if np.isfinite(args[6]).any():
            assert (got[0] >= 0).all()  # the fallback really selected rails


def test_padding_rows_never_selected():
    args = tuple(np.asarray(a, dtype=float) for a in
                 ([100], [0.0], [0.0], [1e9], [0.0], [1.0], [1.0], [True], [4096, 4096, 4096]))
    choices, _, queued, rr = _run_padded(args, 0, 0.05)
    assert (choices == 0).all() and rr == 3 and queued[0] == 100 + 3 * 4096


def test_scores_and_single_choice_twins():
    rng = np.random.default_rng(13)
    for _ in range(20):
        q, _, _, bw, b0, b1, pen, ex, lengths = _pad_choose_args(rng, 6, 1)
        length = int(lengths[0])
        want = pen * (b0 + b1 * (q + length) / bw)
        got = tent_scores_torch(q, bw, b0, b1, pen, length).numpy()
        assert np.array_equal(want, got)
        rr = int(rng.integers(0, 50))
        c = int(tent_choose_torch(q, bw, b0, b1, pen, length, rr, 0.05, excluded=ex))
        s = np.where(ex, np.inf, want)
        s = want if np.isinf(s.min()) else s
        if np.isinf(s.min()):
            assert c == -1
        else:
            window = np.flatnonzero(s <= 1.05 * s.min())
            assert c == window[rr % len(window)]


def _seeded_store(module, rng, n_links):
    store = module.TelemetryStore()
    for i in range(n_links):
        desc = module.LinkDesc(link_id=i, node=0, link_class=module.LinkClass.RDMA, index=i,
                               numa=0, bandwidth=float(rng.choice([25e9, 1e9])),
                               base_latency=5e-6)
        tl = store.ensure(desc)
        tl.queued_bytes = int(rng.integers(0, 1 << 30))
        tl.beta0 = float(rng.uniform(0.0, 1e-2))
        tl.beta1 = float(rng.uniform(0.05, 50.0))
        tl.ewma_service_time = float(rng.uniform(0.0, 1.0))
    return store


class _Policy:  # the drain only touches the store
    _rr = 0
    gamma = 0.05


_STATE = ("beta0_arr", "beta1_arr", "queued_arr", "ewma_service_arr", "completions_arr")


def test_adapter_drain_equals_reference_store_drain():
    rng = np.random.default_rng(47)
    for case in range(40):
        n_links, seed = int(rng.integers(1, 7)), int(rng.integers(0, 1 << 30))
        a = _seeded_store(ref_core, np.random.default_rng(seed), n_links)
        b = _seeded_store(port_core, np.random.default_rng(seed), n_links)
        m = int(rng.integers(1, 40))
        batch = (rng.integers(0, n_links, size=m), rng.integers(0, 1 << 22, size=m),
                 rng.integers(0, 1 << 24, size=m), rng.uniform(0.0, 5.0, size=m))
        a.on_complete_many(*batch)
        core = EngineJitCore(_Policy(), b, device="cpu")
        core.on_complete_many(*batch)
        assert core.drains == 1
        for name in _STATE:
            assert np.array_equal(getattr(a, name)[:a.n], getattr(b, name)[:b.n]), (case, name)


def test_scratch_row_survives_padding():
    a = _seeded_store(ref_core, np.random.default_rng(9), 3)
    b = _seeded_store(port_core, np.random.default_rng(9), 3)
    batch = tuple(np.asarray(c) for c in ([0, 2, 2], [4096, 1 << 20, 0], [100, 5000, 0],
                                          [0.25, 0.5, 0.75]))
    a.on_complete_many(*batch)
    EngineJitCore(_Policy(), b, device="cpu").on_complete_many(*batch)
    for name in _STATE:
        assert np.array_equal(getattr(a, name)[:3], getattr(b, name)[:3])


def test_drain_twin_on_full_state_vectors():
    """The twin's own contract: the padded state in, every row out, the
    scratch row n absorbing the batch padding."""
    store = _seeded_store(port_core, np.random.default_rng(3), 5)
    ps = _bucket(store.n + 1)
    state = [torch.from_numpy(s) for s in store.gather_complete_state(ps)]
    slots = torch.tensor([1, 4, 1, 5, 5], dtype=torch.float64)  # 5 = the scratch row
    zeros = torch.zeros(5, dtype=torch.float64)
    out = tent_on_complete_many_torch(*state, slots, zeros + 4096, zeros + 10, zeros + 0.5)
    ref_store = _seeded_store(ref_core, np.random.default_rng(3), 5)
    ref_store.on_complete_many(np.array([1, 4, 1]), np.full(3, 4096), np.full(3, 10),
                               np.full(3, 0.5))
    for vec, name in zip(out, _STATE):
        assert np.array_equal(vec.numpy()[:5], getattr(ref_store, name)[:5].astype(np.float64))


def _emulated_choose(inp, out, pc, ps):
    """csrc/tent_core.cu's chooser, in its layouts, by the torch twin."""
    cols = [inp[i * pc:(i + 1) * pc] for i in range(8)]
    lengths, valid = inp[8 * pc:8 * pc + ps], inp[8 * pc + ps:8 * pc + 2 * ps]
    c, qa, qo, rr = tent_choose_wave_padded_torch(*cols, lengths, valid,
                                                  int(inp[8 * pc + 2 * ps]),
                                                  float(inp[8 * pc + 2 * ps + 1]))
    out[:ps], out[ps:2 * ps], out[2 * ps:2 * ps + pc] = c.double(), qa, qo
    out[2 * ps + pc] = float(rr)
    tc_kernel.choose_launches += 1


class _EmulatedDrain:
    """csrc/tent_core.cu's staged drain, in its layouts, by the torch twin on
    the first m (live) entries, in place in the staging buffer."""

    def __init__(self, host, device):
        self.host = host

    def __call__(self, ps, pm, m):
        state, batch = self.host[:8 * ps], self.host[8 * ps:8 * ps + 4 * pm]
        outs = tent_on_complete_many_torch(*(state[i * ps:(i + 1) * ps] for i in range(8)),
                                           *(batch[i * pm:i * pm + m] for i in range(4)))
        for i, vec in enumerate(outs):
            state[i * ps:(i + 1) * ps] = vec
        tc_kernel.drain_launches += 1


@pytest.fixture
def emulated_card(monkeypatch):
    """The card path of the adapter on the CPU: a CPU staging's buffers are
    plain CPU tensors, and the kernels are their emulations."""
    monkeypatch.setattr(tc_kernel, "choose_wave_padded", _emulated_choose)
    monkeypatch.setattr(tc_kernel, "StagedDrain", _EmulatedDrain)
    monkeypatch.setattr(tc_kernel, "choose_launches", 0)
    monkeypatch.setattr(tc_kernel, "drain_launches", 0)
    monkeypatch.setattr(tc_ops, "choose_wave_staged", tc_ops.card_choose)
    monkeypatch.setattr(tc_ops, "complete_many_staged", tc_ops.card_drain)


def test_staged_card_path_packs_what_the_kernels_read(emulated_card):
    rng = np.random.default_rng(17)
    for _ in range(10):
        args = _pad_choose_args(rng, int(rng.integers(1, 20)), int(rng.integers(1, 70)))
        want = ref_core.tent_choose_wave(*args, 9, gamma=0.05)
        n_c, n_s = len(args[0]), len(args[8])
        c, qa, qo, rr = tc_ops.choose_wave_padded_np(_padded(args), 9, 0.05,
                                                     tc_ops.Staging(CPU))
        assert _same(want, (c[:n_s], qa[:n_s].astype(np.int64), qo[:n_c].astype(np.int64), rr))
    a = _seeded_store(ref_core, np.random.default_rng(2), 4)
    b = _seeded_store(port_core, np.random.default_rng(2), 4)
    batch = (rng.integers(0, 4, size=30), rng.integers(0, 1 << 22, size=30),
             rng.integers(0, 1 << 24, size=30), rng.uniform(0.0, 5.0, size=30))
    a.on_complete_many(*batch)
    EngineJitCore(_Policy(), b, device="cpu").on_complete_many(*batch)
    for name in _STATE:
        assert np.array_equal(getattr(a, name)[:4], getattr(b, name)[:4])
    assert tc_kernel.choose_launches == 10 and tc_kernel.drain_launches == 1


@pytest.mark.parametrize("path", ["cpu", "card"])
def test_live_count_leaves_the_scratch_row_as_gathered(path, request):
    """The live-count contract, the same on both devices: a drain reads the
    first m entries of its padded batch and nothing past them (the tail is
    NaN here), rows 0..n-1 equal the reference store's drain, and the
    scratch row n and the inert rows past it keep their gathered values."""
    if path == "card":
        request.getfixturevalue("emulated_card")
    n_links, m = 5, 11
    rng = np.random.default_rng(23)
    batch = (rng.integers(0, n_links, size=m), rng.integers(0, 1 << 22, size=m),
             rng.integers(0, 1 << 24, size=m), rng.uniform(0.0, 5.0, size=m))
    a = _seeded_store(ref_core, np.random.default_rng(4), n_links)
    a.on_complete_many(*batch)
    store = _seeded_store(port_core, np.random.default_rng(4), n_links)
    ps, pm = _bucket(n_links + 1), _bucket(m)
    staging = tc_ops.Staging(CPU)
    state, cols = staging.drain_inputs(ps, pm)
    gathered = np.stack(store.gather_complete_state(ps, out=state))
    for col, v in zip(cols, batch):
        col[:m] = v
        col[m:] = np.nan
    out = np.stack(tc_ops.complete_many_staged(staging, ps, pm, m))
    for k, name in enumerate(_STATE):
        assert np.array_equal(out[k, :n_links], getattr(a, name)[:n_links].astype(np.float64))
    assert np.array_equal(out[:, n_links:], gathered[:5, n_links:])
    if path == "card":
        assert tc_kernel.drain_launches == 1


def _with_jit(spec):
    return dataclasses.replace(spec, engine=dataclasses.replace(spec.engine, jit_core=True))


@pytest.fixture
def forced_crossover(monkeypatch):
    for name in ("JIT_MIN", "JIT_MIN_FLOOR", "JIT_MIN_CEIL"):
        monkeypatch.setattr(jit_core, name, 1)


@pytest.mark.parametrize("name", ["single_rail_flap", "elephant_mice_mix",
                                  "degrade_recover_ramp"])
def test_forced_crossover_parity(name, forced_crossover):
    """Crossover pinned to 1: every wave and completion batch goes through
    the kernels' plain versions, and the reports equal the reference's."""
    spec = ref.get(name)
    want = ref.ScenarioRunner(spec).run().to_dict()["policies"]
    got = port.ScenarioRunner(_with_jit(port.ScenarioSpec.from_json(spec.to_json())),
                              device="cpu").run().to_dict()["policies"]
    assert got == want


def test_both_kernels_engage(forced_crossover, emulated_card):
    """The reference's engagement case: a zero-jitter fabric, 64 slices over
    8 identical rails completing in same-timestamp groups of 8; both kernel
    entries launch, and the bytes arrive."""
    from repro_torch.core import Fabric, Topology
    from repro_torch.core.types import Location, MemoryKind

    topo = Topology(FabricSpec())
    eng = TentEngine(topology=topo, fabric=Fabric(topo, seed=0, jitter=0.0),
                     config=EngineConfig(jit_core=True), device="cpu")
    n = 4 << 20
    src = eng.register_segment(Location(node=0, kind=MemoryKind.HOST_DRAM, numa=0), n)
    dst = eng.register_segment(Location(node=1, kind=MemoryKind.HOST_DRAM, numa=0), n)
    src.write(0, np.arange(n, dtype=np.uint8))
    res = eng.transfer_sync(src.segment_id, 0, dst.segment_id, 0, n)
    assert res.ok
    np.testing.assert_array_equal(dst.read(0, n), np.arange(n, dtype=np.uint8))
    assert tc_kernel.choose_launches > 0 and tc_kernel.drain_launches > 0
    assert eng._jit.waves == tc_kernel.choose_launches
    assert eng._jit.drains == tc_kernel.drain_launches


def test_crossover_tuner_tracks_the_wave_min_shape():
    assert (jit_core.JIT_MIN, jit_core.JIT_MIN_FLOOR, jit_core.JIT_MIN_CEIL) == (
        32, 16, 64)
    core = EngineJitCore(_Policy(), _seeded_store(port_core, np.random.default_rng(1), 2),
                         device="cpu")
    assert core.min_batch == jit_core.JIT_MIN
    core.tune(2.0 * jit_core.JIT_MIN)
    assert core.min_batch == jit_core.JIT_MIN_FLOOR
    core.tune(0.5 * jit_core.JIT_MIN)
    assert core.min_batch == jit_core.JIT_MIN_CEIL
    core.tune(1.2 * jit_core.JIT_MIN)
    assert core.min_batch == jit_core.JIT_MIN
    assert [_bucket(n) for n in (1, 8, 9, 33, 1024)] == [8, 8, 16, 64, 1024]


def test_no_card_means_no_jitted_core(monkeypatch):
    """device None means CUDA: without a card the engine refuses, it never
    takes the numpy path quietly; baseline policies ignore the flag."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TentEngine(FabricSpec(n_nodes=2), config=EngineConfig(jit_core=True))
    eng = TentEngine(FabricSpec(n_nodes=2), config=EngineConfig(jit_core=True,
                                                                policy="round_robin"))
    assert eng._jit is None
