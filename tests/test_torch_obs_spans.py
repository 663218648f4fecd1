"""The port's host-clock span recorder (`repro_torch.obs.spans`) on the
serving path, on the CPU at smoke sizes.

Each test pins one fact: spans nest under their request; the recorder
moves no byte and changes no result or counter of the engine; inside the
engine's event loop each slice copies its bytes once and reads its source
in place, stage-in registers the bytes in place, and a served request on
the CPU, as on a card, copies once what it ships and hands out twice that
in place; accumulators are exclusive; the segments registered
are counted, two a handoff in flight; ranges open only under a profiler;
prefill counts its cache's state and K/V bytes and each MoE call is a
span; and with nothing attached every site does nothing.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from pd_handoff import pd_engine, ship
from repro_torch.core import Location, MemoryKind
from repro_torch.models import init_params
from repro_torch.obs import spans
from repro_torch.serving import DisaggregatedServer, bytes_to_tree, greedy_decode

KV_BYTES = 16 << 20  # 256 slices of 64 KiB
COUNTERS = ("waves", "slices_issued", "slices_retried", "completions_drained",
            "completion_batches", "backend_substitutions")


@pytest.fixture
def recorder():
    rec = spans.attach()
    yield rec
    spans.detach()


def _data(seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, KV_BYTES, dtype=np.uint8)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("qwen2-0.5b").with_(remat="none")
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    prompt = torch.from_numpy(
        np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 12), dtype=np.int64))
    return cfg, params, prompt


def test_off_by_default_every_site_is_a_null_context():
    assert spans.active is None
    for ctx in (spans.span("serving.pack"), spans.request()):
        with ctx as sp:
            assert sp is None


@pytest.mark.parametrize("flap", [False, True], ids=["steady", "flap"])
def test_recorder_moves_the_same_bytes_and_leaves_results_and_counters(flap):
    data = _data()
    runs = []
    for attached in (False, True):
        eng = pd_engine()
        if attached:
            spans.attach()
        try:
            dst, res = ship(eng, data, flap=flap)
            got = dst.read(0, data.size)
        finally:
            spans.detach()
        runs.append((got, (res.ok, res.submitted_at, res.completed_at, res.bytes, res.error),
                     {c: getattr(eng, c) for c in COUNTERS}))
    (got0, res0, cnt0), (got1, res1, cnt1) = runs
    assert np.array_equal(got0, data) and np.array_equal(got1, data)
    assert res0 == res1 and res0[0]
    assert cnt0 == cnt1
    assert cnt0["slices_retried"] > 0 if flap else cnt0["slices_retried"] == 0


def test_engine_run_copies_exactly_twice_the_bytes_shipped(recorder):
    """The event loop copies the bytes shipped once (each slice's write,
    retried slices included) and hands them out in place once (each
    slice's read). The name keeps the count from before slices read in
    place, so that the test keeps its identity."""
    data = _data()
    with recorder.request(keep=True) as root:
        ship(pd_engine(), data, flap=True)
    by_name = {s.name: s for s in recorder.take(root.request)}
    assert by_name["engine.run"].counters["copy_bytes"] == data.size
    assert by_name["engine.run"].counters["inplace_bytes"] == data.size
    assert by_name["serving.stage_in"].counters.get("copy_bytes", 0) == 0
    assert by_name["serving.stage_in"].counters["adopted_bytes"] == data.size
    assert "copy_bytes" not in by_name["engine.submit"].counters


def test_accumulators_are_exclusive(recorder):
    """A drain's nanoseconds leave out the dispatches and copies inside it,
    so the engine loop's parts never exceed the loop; and a nested
    accumulator is subtracted from the one around it."""
    with recorder.request(keep=True) as root:
        ship(pd_engine(), _data(), flap=True)
        with recorder.span("outer") as outer:
            t0 = recorder.begin()
            t1 = recorder.begin()
            recorder.end(t1, "inner_ns", "inner_n", 1)
            recorder.end(t0, "outer_ns", "outer_n", 1)
    got = {s.name: s for s in recorder.take(root.request)}
    run, submit = got["engine.run"], got["engine.submit"]
    parts = [run.counters.get(k, 0) for k in ("dispatch_ns", "drain_ns", "copy_ns")]
    assert run.counters["drain_ns"] > 0 and run.counters["copy_ns"] > 0
    assert sum(parts) <= run.ns
    assert 0 < submit.counters["dispatch_ns"] <= submit.ns and submit.counters["dispatch_n"] == 1
    c = outer.counters
    assert c["inner_n"] == c["outer_n"] == 1
    assert 0 <= c["outer_ns"] and c["inner_ns"] + c["outer_ns"] <= outer.ns


def test_a_served_request_nests_every_span_under_its_id(recorder, smoke):
    """`generate` inside a kept request is part of it: one root, one id."""
    cfg, params, prompt = smoke
    server = DisaggregatedServer(pd_engine(), cfg, params)
    with recorder.request(keep=True) as first:
        server.generate(prompt, 3, 16, async_handoff=True)
    with recorder.request(keep=True) as second:
        server.generate(prompt, 3, 16, async_handoff=True)
    got = recorder.take(first.request)
    assert second.request != first.request and recorder.take(second.request)
    root = got[0]
    assert root is first and root.name == spans.REQUEST and root.parent == 0
    assert [s.name for s in got].count(spans.REQUEST) == 1
    by_id = {s.id: s for s in got}
    for s in got[1:]:
        assert s.request == root.request
        parent = by_id[s.parent]
        assert parent.start <= s.start <= s.end <= parent.end, (s, parent)
    names = [s.name for s in got]
    assert {"serving.pack", "serving.register", "serving.stage_in", "engine.submit",
            "engine.run", "serving.unpack", "serving.first_token"} <= set(names)
    # the replayed prefill's 12 steps, then the 2 decode steps
    assert names.count("model.decode_step") == 12 + 2
    mark = got[names.index("serving.first_token")]
    assert mark.ns == 0 and mark.start >= got[names.index("serving.unpack")].end


def test_a_served_request_copies_five_times_what_it_ships(recorder, smoke):
    """One host copy of the cache, on the CPU as on a card: each slice's
    write. Two more pass in place: each slice's read of its source and the
    read-out of the landed view. `bytes_to_tree` copies nothing on the
    host: its leaves are views of the read-out. The name keeps the count
    from before the handoff registered and read its bytes in place, so
    that the test keeps its identity."""
    cfg, params, prompt = smoke
    server = DisaggregatedServer(pd_engine(), cfg, params)
    with recorder.request(keep=True) as root:
        res = server.generate(prompt, 3, 16, async_handoff=True)
    got = recorder.take(root.request)
    copied = sum(s.counters.get("copy_bytes", 0) for s in got)
    inplace = sum(s.counters.get("inplace_bytes", 0) for s in got)
    assert copied == res.kv_bytes and inplace == 2 * res.kv_bytes
    unpack = next(s for s in got if s.name == "serving.unpack")
    assert unpack.counters == {}
    run = next(s for s in got if s.name == "engine.run")
    assert run.counters["copy_bytes"] == run.counters["inplace_bytes"] == res.kv_bytes


def test_a_recorder_left_attached_holds_nothing_it_was_not_asked_to_keep(recorder, smoke):
    """`generate`'s own request, spans outside any request and a request
    whose spans were taken leave nothing in the recorder."""
    cfg, params, prompt = smoke
    server = DisaggregatedServer(pd_engine(), cfg, params)
    server.generate(prompt, 3, 16, async_handoff=True)
    with recorder.span("outside"):
        recorder.mark("serving.first_token")
    with recorder.request(keep=True) as root:
        server.generate(prompt, 3, 16, async_handoff=True)
    assert list(recorder._kept) == [root.request]
    assert recorder.take(root.request) and recorder._kept == {}
    assert recorder._open == [] and recorder._saved == []


def test_register_counts_the_segments_left_registered(recorder):
    """Each handoff's two segments are the only ones registered while it
    is in flight, and none is left once its batch has landed."""
    eng = pd_engine()
    data = _data()
    for _ in range(2):
        with recorder.request(keep=True) as root:
            ship(eng, data)
        reg = next(s for s in recorder.take(root.request) if s.name == "serving.register")
        assert reg.counters == {"segments_live": 2, "segment_bytes_live": 2 * data.size}
        assert eng.segments.live() == (0, 0)
    seg = eng.register_segment(Location(node=0, kind=MemoryKind.HOST_DRAM, device=0, numa=0),
                               data.size)
    assert eng.segments.live() == (1, data.size)
    eng.segments.deregister(seg.segment_id)
    assert eng.segments.live() == (0, 0)


def test_decode_steps_each_open_a_span(recorder, smoke):
    cfg, params, prompt = smoke
    from repro_torch.models import prefill_forward

    with recorder.request(keep=True) as root:
        logits, kv = prefill_forward(cfg, params, prompt)
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4)) for k, v in kv.items()}
        greedy_decode(cfg, params, cache, logits, prompt.shape[1], 4)
    names = [s.name for s in recorder.take(root.request)]
    assert names == [spans.REQUEST, "model.prefill", "serving.decode"] + ["model.decode_step"] * 3


def test_ranges_open_only_under_a_profiler(recorder, smoke):
    """Spans become `tent.*` ranges while a profiler records; marks and
    accumulators open none."""
    cfg, params, prompt = smoke
    data = _data()[: 1 << 20]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.request():
            ship(pd_engine(), data)
            recorder.mark("serving.first_token")
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    tent = sorted(n for n in names if n.startswith(spans.RANGE_PREFIX))
    assert tent == sorted("tent." + n for n in (
        spans.REQUEST, "serving.register", "serving.stage_in", "engine.submit", "engine.run"))
    with recorder.request(keep=True) as root:
        bytes_to_tree(data, {"k": torch.zeros(data.size, dtype=torch.uint8)})
    assert all(s._range is None for s in recorder.take(root.request))


@pytest.mark.parametrize("arch", ["granite-4.0-h-small", "qwen2-0.5b", "mamba2-370m",
                                  "deepseek-v3"])
def test_prefill_counts_the_cache_and_the_moe(recorder, arch):
    """`model.prefill` counts the bytes of the cache's fixed state and of its
    K/V (deepseek's latent and rope key), from shapes; under an MoE each MoE
    layer's FFN is a `model.moe` span with its routed pairs, from shapes,
    and its held pairs, all of them where the layer holds every expert (a
    share's count, read on the host with a recorder attached, is
    tests/test_torch_deepseek_v3.py's); nothing else that would need the
    experts' counts on the host. MLA layers open a `model.mla` span each."""
    cfg = get_smoke_config(arch).with_(remat="none")
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    from repro_torch.models import prefill_forward

    with recorder.request(keep=True) as root:
        _, cache = prefill_forward(cfg, params, prompt)
    got = recorder.take(root.request)
    prefill = next(s for s in got if s.name == "model.prefill")
    nbytes = {n: t.numel() * t.element_size() for n, t in cache.items()}
    assert prefill.counters == {
        "cache_state_bytes": nbytes.get("ssm_state", 0) + nbytes.get("conv_buf", 0),
        "cache_kv_bytes": nbytes.get("k", 0) + nbytes.get("v", 0)}
    moes = [s for s in got if s.name == "model.moe"]
    assert len(moes) == (cfg.num_layers - cfg.first_k_dense if cfg.num_experts else 0)
    pairs = prompt.numel() * cfg.experts_per_token
    for s in moes:
        assert s.parent == prefill.id
        assert s.counters == {"routed_pairs": pairs, "held_pairs": pairs}
    mlas = [s.parent for s in got if s.name == "model.mla"]
    assert mlas == ([prefill.id] * cfg.num_layers if cfg.mla else [])
    if arch == "granite-4.0-h-small":
        assert prefill.counters["cache_state_bytes"] > 0 and prefill.counters["cache_kv_bytes"] > 0
