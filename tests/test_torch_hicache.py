"""The port's host serving layers against the reference's, on the CPU: the
paged KV pools, HiCache tiering over the engine on materialized pools,
the P-squared percentile sketches, the checkpoint engine and the
performance models. Host numpy in both packages, so every number and
every byte is compared for equality."""
import dataclasses

import numpy as np
import pytest

import repro.configs as ref_configs
import repro.core as ref_core
import repro.serving as ref_serving
import repro_torch.configs as port_configs
import repro_torch.core as port_core
import repro_torch.serving as port_serving

ARCHS = ["qwen2-0.5b", "mamba2-370m", "hymba-1.5b", "qwen3-moe-235b-a22b", "deepseek-7b"]


def _hicache(serving, engine, cfg, *, gpu_pages=4, cpu_pages=32, disk_pages=64,
             page_tokens=16):
    """The reference example's three-tier layout (examples/disaggregated_serving.py)."""
    pb = serving.kv_bytes_per_token(cfg) * page_tokens
    return serving.HiCache(
        engine, cfg,
        gpu_pool=serving.make_gpu_pool(engine, 0, 0, page_bytes=pb, num_pages=gpu_pages),
        cpu_pool=serving.make_cpu_pool(engine, 1, page_bytes=pb, num_pages=cpu_pages),
        disk_pool=serving.make_disk_pool(engine, 1, page_bytes=pb, num_pages=disk_pages),
        page_tokens=page_tokens)


def _both_hicaches(**kw):
    """One HiCache per package on the same fabric, engine and model config."""
    out = []
    for serving, core, configs in ((ref_serving, ref_core, ref_configs),
                                   (port_serving, port_core, port_configs)):
        cfg = configs.get_smoke_config("qwen2-0.5b")
        engine = core.TentEngine(core.FabricSpec(), seed=0)
        out.append(_hicache(serving, engine, cfg, **kw))
    return out


def _state(hc) -> dict:
    """What a run of a HiCache shows: tiers, stats, the clock, and the bytes
    of every indexed page in its pool."""
    pages = {k: (e.tier, e.page.offset, e.last_used, e.token_count,
                 e.page.pool.read_page(e.page).tobytes())
             for k, e in sorted(hc.index.items())}
    return {"tiers": hc.tier_counts(), "hits": hc.hits, "misses": hc.misses,
            "promoted": hc.bytes_promoted, "demoted": hc.bytes_demoted,
            "now": hc.engine.fabric.now, "pages": pages,
            "free": {t: p.free_pages for t, p in hc.pools.items() if p is not None}}


def _fetch(res) -> tuple:
    return (res.prefix_tokens, [p.offset for p in res.pages], res.promoted_pages,
            res.transfer_seconds, res.bytes_moved)


def _payload(seed, hc, n_tokens):
    pages = n_tokens // hc.page_tokens
    return np.random.default_rng(seed).integers(0, 256, pages * hc.page_bytes, dtype=np.uint8)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_bytes_per_token(arch):
    assert (port_serving.kv_bytes_per_token(port_configs.get_config(arch))
            == ref_serving.kv_bytes_per_token(ref_configs.get_config(arch)))


def test_kv_bytes_per_token_full_width_qwen2():
    assert port_serving.kv_bytes_per_token(port_configs.get_config("qwen2-0.5b")) == 12288


def test_page_pool_alloc_free_and_errors():
    engine = port_core.TentEngine(port_core.FabricSpec(), seed=0)
    pool = port_serving.make_cpu_pool(engine, 0, page_bytes=64, num_pages=3)
    other = port_serving.make_cpu_pool(engine, 1, page_bytes=64, num_pages=3)
    pages = [pool.alloc() for _ in range(3)]
    assert pool.alloc() is None and pool.free_pages == 0
    assert sorted(p.offset for p in pages) == [0, 64, 128]
    data = np.arange(64, dtype=np.uint8)
    pool.write_page(pages[1], data)
    np.testing.assert_array_equal(pool.read_page(pages[1]), data)
    pool.free(pages[1])
    with pytest.raises(ValueError, match="double free"):
        pool.free(pages[1])
    with pytest.raises(ValueError, match="belongs to"):
        other.free(pages[0])
    again = pool.alloc()
    assert again.offset == pages[1].offset and again.page_id != pages[1].page_id
    with pytest.raises(ValueError, match="double free"):
        pool.free(pages[1])  # a stale handle to a reused slot


def test_page_pool_matches_reference_sequence():
    got, want = [], []
    for serving, core, out in ((port_serving, port_core, got), (ref_serving, ref_core, want)):
        engine = core.TentEngine(core.FabricSpec(), seed=0)
        pool = serving.make_gpu_pool(engine, 0, 3, page_bytes=128, num_pages=5)
        live = [pool.alloc() for _ in range(4)]
        pool.free(live[2])
        pool.free(live[0])
        live += [pool.alloc(), pool.alloc(), pool.alloc()]
        out.append([(p.page_id, p.offset) if p else None for p in live])
        out.append((pool.segment.name, pool.segment.length, pool.free_pages))
    assert got == want


def test_hicache_demote_and_promote_matches_reference():
    """Two 64-token conversations into a 4-page GPU tier: the second demotes
    the first, and fetching the first promotes it back over the fabric."""
    ref_hc, port_hc = _both_hicaches()
    convo_a, convo_b = list(range(64)), list(range(1000, 1064))
    states, fetches = [], []
    for hc in (ref_hc, port_hc):
        pay_a, pay_b = _payload(1, hc, 64), _payload(2, hc, 64)
        demote_a = hc.insert(convo_a, pay_a)
        demote_b = hc.insert(convo_b, pay_b)
        mid = hc.tier_counts()
        res = hc.fetch_prefix(convo_a)
        got = np.concatenate([p.pool.read_page(p) for p in res.pages])
        np.testing.assert_array_equal(got, pay_a)  # promoted bytes are the inserted ones
        miss = hc.fetch_prefix(list(range(5000, 5064)))
        fetches.append((demote_a, demote_b, mid, _fetch(res), _fetch(miss)))
        states.append(_state(hc))
    assert fetches[1] == fetches[0]
    assert fetches[1][2] == {"gpu": 4, "cpu": 4, "disk": 0}
    assert fetches[1][3][2] == 4 and fetches[1][3][3] > 0
    assert states[1] == states[0]


def test_hicache_spills_to_disk_and_partial_prefix_matches_reference():
    ref_hc, port_hc = _both_hicaches(gpu_pages=2, cpu_pages=3, disk_pages=16)
    convos = [list(range(i * 1000, i * 1000 + 48)) for i in range(4)]
    out = []
    for hc in (ref_hc, port_hc):
        for i, c in enumerate(convos):
            hc.insert(c, _payload(10 + i, hc, 48))
        partial = hc.fetch_prefix(convos[0][:32] + [99999] * 16)
        out.append((_fetch(partial), _state(hc)))
    assert out[1] == out[0]
    assert out[1][1]["tiers"]["disk"] > 0


def test_hicache_async_paths_match_reference():
    """`insert_async` and `fetch_prefix_async` on the same virtual clock,
    completions delivered by the engine."""
    ref_hc, port_hc = _both_hicaches(gpu_pages=4)
    convos = [list(range(i * 500, i * 500 + 32)) for i in range(3)]
    out = []
    for hc in (ref_hc, port_hc):
        events = []
        for c in convos:
            hc.insert_async(c, lambda s: events.append(("insert", s)))
        hc.engine.run_until_idle()
        for c in convos[:2]:
            hc.fetch_prefix_async(c, lambda r: events.append(("fetch", _fetch(r))))
        hc.engine.run_until_idle()
        out.append((events, _state(hc)))
    assert out[1] == out[0]
    assert any(kind == "fetch" and res[2] > 0 for kind, res in out[1][0])


@pytest.mark.parametrize("n", [7, 999, 1000, 1001, 20000])
def test_percentile_sketch_matches_reference(n):
    """Exact below the 1000-sample buffer, P-squared above it; seeded
    lognormal stream, compared for equality."""
    xs = np.random.default_rng(n).lognormal(0.0, 1.0, n).tolist()
    got, want = port_serving.PercentileSketch(), ref_serving.PercentileSketch()
    for x in xs:
        got.add(x)
        want.add(x)
    for q in (50, 90, 99):
        assert got.percentile(q) == want.percentile(q)
    assert (got.count, got.total, got.max, got.mean) == (want.count, want.total, want.max,
                                                         want.mean)
    if n > 1000:
        with pytest.raises(ValueError):
            got.percentile(75)


@pytest.mark.parametrize("q", [0.1, 0.5, 0.99])
def test_p2_quantile_matches_reference(q):
    xs = np.random.default_rng(3).standard_normal(5000).tolist()
    got, want = port_serving.P2Quantile(q), ref_serving.P2Quantile(q)
    trail = []
    for i, x in enumerate(xs):
        got.add(x)
        want.add(x)
        if i % 97 == 0:
            trail.append((got.value(), want.value()))
    assert all(a == b for a, b in trail)
    assert got.value() == want.value()


def test_checkpoint_update_is_byte_exact_and_matches_reference():
    rng = np.random.default_rng(4)
    table = {"w1": rng.standard_normal((96, 80)).astype(np.float32),
             "b1": rng.standard_normal(80).astype(np.float32),
             "emb": rng.integers(0, 256, 70_001, dtype=np.uint8)}
    out = []
    for serving, core in ((ref_serving, ref_core), (port_serving, port_core)):
        engine = core.TentEngine(core.FabricSpec(), seed=1)
        nic = engine.topology.rdma_nic(0, 2)
        engine.fabric.schedule_degradation(nic.link_id, at=0.0, until=1e9, factor=0.15)
        ce = serving.CheckpointEngine(engine, nodes=2, gpus_per_node=8)
        ce.register_checkpoint(table)
        res = ce.update(verify=True)
        tables = [ce.rank_table(r) for r in range(ce.world)]
        out.append((dataclasses.astuple(res), ce.shard_bytes,
                    [{k: v.tobytes() for k, v in t.items()} for t in tables],
                    engine.slices_issued, engine.waves))
    assert out[1] == out[0]
    landed = {k: v for t in out[1][2] for k, v in t.items()}
    for name, arr in table.items():
        if name in landed:
            assert landed[name] == arr.tobytes()


def test_checkpoint_rejects_empty_tables():
    engine = port_core.TentEngine(port_core.FabricSpec(), seed=0)
    ce = port_serving.CheckpointEngine(engine, nodes=1, gpus_per_node=2)
    with pytest.raises(ValueError, match="empty"):
        ce.register_checkpoint({})
    with pytest.raises(ValueError, match="zero bytes"):
        ce.register_checkpoint({"x": np.zeros(0, np.float32)})


@pytest.mark.parametrize("arch", ARCHS)
def test_perf_models_match_reference(arch):
    assert dataclasses.astuple(port_serving.from_table2()) == dataclasses.astuple(
        ref_serving.from_table2())
    got = port_serving.from_roofline(port_configs.get_config(arch), chips=8)
    want = ref_serving.from_roofline(ref_configs.get_config(arch), chips=8)
    assert (got.prefill_tokens_per_s, got.tpot) == (want.prefill_tokens_per_s, want.tpot)
    assert got.prefill_seconds(4096) == want.prefill_seconds(4096)
