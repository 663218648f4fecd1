"""The KV handoff's segments registered in place and released when the batch
lands (`SegmentManager.register(buffer=...)`, `DisaggregatedServer`).

On the CPU: a segment over a caller's array aliases it and copies nothing;
what cannot be adopted is refused; `ship_kv_async` deregisters both segments
on a landed and on a failed batch while the destination it returned still
reads, and so does the blocking `ship_kv`, under a rail flap too; the
engine's records of the batch then hold none of its bytes; each handoff is
the only one registered while in flight; mixed-dtype caches at unaligned
offsets go through the server byte for byte, with no host copy in
`bytes_to_tree`, whose leaves are views at 16-byte offsets. The test
marked `card` packs into pinned memory and unpacks on an NVIDIA card; it
skips without one (`python -m pytest -m card tests/test_torch_kv_adoption.py`).
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from pd_handoff import pd_engine, ship
from repro_torch.core import Location, MemoryKind, SegmentManager
from repro_torch.models import init_params
from repro_torch.obs import spans
from repro_torch.serving import DisaggregatedServer, bytes_to_tree, tree_to_bytes

HOST = Location(node=0, kind=MemoryKind.HOST_DRAM, device=0, numa=0)


@pytest.fixture
def recorder():
    rec = spans.attach()
    yield rec
    spans.detach()


def _mixed_tree(device="cpu", seed=5):
    """bf16 and fp32 leaves with odd element counts, so that most byte
    offsets in the packed stream are not a multiple of 4 or 16."""
    g = torch.Generator().manual_seed(seed)
    tree = {"a": torch.randn(3, 5, 7, generator=g).to(torch.bfloat16),
            "b": torch.randn(11, 3, generator=g),
            "c": {"x": torch.randn(1, 9, generator=g).to(torch.bfloat16),
                  "y": torch.randn(2, 2, 5, generator=g)},
            "d": torch.randn(13, generator=g).to(torch.bfloat16)}
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else {kk: vv.to(device) for kk, vv in v.items()}) for k, v in tree.items()}


def _flat(tree):
    return [tree[k] for k in ("a", "b")] + [tree["c"][k] for k in ("x", "y")] + [tree["d"]]


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.cpu().contiguous().view(torch.uint8),
                            b.cpu().contiguous().view(torch.uint8)))


def test_register_over_a_buffer_aliases_it_and_copies_nothing(recorder):
    buf = np.arange(4096, dtype=np.int64).astype(np.uint8)
    mgr = SegmentManager()
    with recorder.request(keep=True) as root:
        seg = mgr.register(HOST, buf.size, buffer=buf)
    assert len(seg.buffers) == 1 and seg.buffers[0].data is buf
    assert all("copy_bytes" not in s.counters for s in recorder.take(root.request))
    seg.write(100, np.full(8, 7, np.uint8))
    assert (buf[100:108] == 7).all()
    buf[0] = 201
    assert seg.read(0, 1)[0] == 201
    assert mgr.live() == (1, buf.size)


def test_a_dropped_segment_holds_no_bytes_and_its_view_still_reads():
    buf = np.arange(512, dtype=np.int64).astype(np.uint8)
    seg = SegmentManager().register(HOST, buf.size, buffer=buf)
    view = seg.view()
    seg.drop_bytes()
    assert seg.buffers == [] and seg.phantom and seg.length == buf.size
    seg.write(0, np.full(16, 9, np.uint8))  # a late slice: dropped
    assert not seg.read(0, 16).any()
    np.testing.assert_array_equal(view.read(0, buf.size), buf)
    assert view.segment_id == seg.segment_id and not view.phantom


@pytest.mark.parametrize("case", [
    "dtype", "size", "strided", "two_d", "init", "n_buffers", "phantom"])
def test_register_refuses_what_it_cannot_adopt(case):
    n = 256
    buf = np.zeros(n, np.uint8)
    kw = {"buffer": buf}
    if case == "dtype":
        kw["buffer"] = np.zeros(n // 4, np.int32).view(np.float32)
    elif case == "size":
        kw["buffer"] = np.zeros(n + 1, np.uint8)
    elif case == "strided":
        kw["buffer"] = np.zeros(2 * n, np.uint8)[::2]
    elif case == "two_d":
        kw["buffer"] = np.zeros((16, 16), np.uint8)
    elif case == "init":
        kw["init"] = buf
    elif case == "n_buffers":
        kw["n_buffers"] = 2
    elif case == "phantom":
        kw["materialize"] = False
    mgr = SegmentManager()
    with pytest.raises(ValueError):
        mgr.register(HOST, n, **kw)
    assert mgr.live() == (0, 0)


def _fail_every_link(eng) -> None:
    now = eng.fabric.now
    for lid in eng.fabric.links:
        eng.fabric.schedule_failure(lid, at=now + 1e-4, recover_at=now + 1e6)


@pytest.mark.parametrize("case", ["landed", "failed", "blocking"])
def test_ship_kv_async_releases_both_segments_when_the_batch_lands(case):
    """`blocking`: `ship_kv` under a rail flap, then on a handoff that
    fails, beside a segment of the caller's own that stays registered."""
    eng = pd_engine()
    data = np.random.default_rng(2).integers(0, 256, 1 << 20, dtype=np.uint8)
    if case == "blocking":
        own = eng.register_segment(HOST, 4096)
        before = eng.segments.live()
        dst, res = ship(eng, data, flap=True)
        assert res.ok and eng.slices_retried > 0 and eng.segments.live() == before
        np.testing.assert_array_equal(dst.read(0, data.size), data)
        _fail_every_link(eng)
        dst, res = ship(eng, data)
        assert not res.ok and res.error and eng.segments.live() == before
        assert dst.read(0, data.size).shape == data.shape
        with pytest.raises(KeyError):
            eng.segments.get(dst.segment_id)
        assert eng.segments.get(own.segment_id) is own
        return
    fail = case == "failed"
    if fail:
        _fail_every_link(eng)
    server = DisaggregatedServer(eng, None, None)
    seen = []
    dst, _ = server.ship_kv_async(data, lambda res: seen.append((res.ok, eng.segments.live())))
    assert eng.segments.live() == (2, 2 * data.size)
    eng.run_until_idle()
    # the caller's callback runs once, after both segments are gone
    assert seen == [(not fail, (0, 0))]
    got = dst.read(0, data.size)
    assert got.shape == data.shape
    if not fail:
        np.testing.assert_array_equal(got, data)
    with pytest.raises(KeyError):
        eng.segments.get(dst.segment_id)


def test_a_landed_handoff_leaves_its_bytes_to_the_caller_alone():
    """Once the batch has landed, neither the registry nor the engine's
    record of the batch holds the source or the destination's bytes: they
    are freed with the caller's last reference."""
    data = np.random.default_rng(3).integers(0, 256, 1 << 20, dtype=np.uint8)
    dst, res = ship(pd_engine(), data)
    assert res.ok
    shipped = weakref.ref(data)
    landed = weakref.ref(dst.buffers[0].data)
    np.testing.assert_array_equal(dst.read(0, data.size), data)
    del data, dst
    gc.collect()
    assert shipped() is None and landed() is None


def test_stage_in_copies_what_it_cannot_adopt(recorder):
    """A caller's strided view is copied into a segment of its own, and
    still arrives byte for byte."""
    base = np.random.default_rng(4).integers(0, 256, 1 << 18, dtype=np.uint8)
    data = base[::2]
    with recorder.request(keep=True) as root:
        dst, res = ship(pd_engine(), data)
    assert res.ok
    np.testing.assert_array_equal(dst.read(0, data.size), data)
    stage = next(s for s in recorder.take(root.request) if s.name == "serving.stage_in")
    assert stage.counters["copy_bytes"] == data.size and "adopted_bytes" not in stage.counters


@pytest.mark.parametrize("async_handoff", [False, True], ids=["sync", "async"])
def test_every_served_handoff_is_the_only_one_registered(recorder, async_handoff):
    cfg = get_smoke_config("qwen2-0.5b").with_(remat="none")
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    server = DisaggregatedServer(pd_engine(), cfg, params)
    prompt = torch.from_numpy(
        np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 12), dtype=np.int64))
    for _ in range(3):
        with recorder.request(keep=True) as root:
            res = server.generate(prompt, 2, 16, async_handoff=async_handoff)
        got = {s.name: s for s in recorder.take(root.request)}
        assert got["serving.register"].counters == {
            "segments_live": 2, "segment_bytes_live": 2 * res.kv_bytes}
        assert got["serving.stage_in"].counters["adopted_bytes"] == res.kv_bytes
        assert server.engine.segments.live() == (0, 0)


def test_mixed_dtype_cache_round_trips_through_the_server_byte_exact(recorder):
    tree = _mixed_tree()
    data, metas = tree_to_bytes(tree)
    assert [m[1] for m in metas] == ["bfloat16", "float32", "bfloat16", "float32", "bfloat16"]
    with recorder.request(keep=True) as root:
        dst, res = ship(pd_engine(), data)
        back = bytes_to_tree(dst.read(0, data.size), tree)
    assert res.ok
    for want, got in zip(_flat(tree), _flat(back)):
        assert _bits_equal(got, want)
    unpack = next(s for s in recorder.take(root.request) if s.name == "serving.unpack")
    assert "copy_bytes" not in unpack.counters


def test_unpack_views_aligned_leaves_and_copies_the_rest():
    """Each leaf is its byte range of the one buffer on its device (on the
    CPU `data` itself), a view where the offset is a multiple of 16 and a
    copy elsewhere."""
    tree = _mixed_tree()
    data, _ = tree_to_bytes(tree)
    flat = torch.from_numpy(data)
    leaves = _flat(tree)
    out = _flat(bytes_to_tree(data, tree))
    off = 0
    for want, got in zip(leaves, out):
        assert _bits_equal(got, want)
        shares = got.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
        assert shares == (off % 16 == 0), off
        off += want.numel() * want.element_size()


@pytest.mark.card
def test_pinned_round_trip_on_a_card(recorder):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    tree = _mixed_tree(dev)
    eng = pd_engine()
    with recorder.request(keep=True) as root:
        data, _ = tree_to_bytes(tree)
        dst, res = ship(eng, data, params={"w": torch.zeros(1, device=dev)})
        back = bytes_to_tree(dst.read(0, data.size), tree)
    assert res.ok and eng.segments.live() == (0, 0)
    assert torch.from_numpy(data).is_pinned()
    assert torch.from_numpy(dst.buffers[0].data).is_pinned()
    for want, got in zip(_flat(tree), _flat(back)):
        assert got.device == dev and _bits_equal(got, want)
    got = {s.name: s for s in recorder.take(root.request)}
    assert got["serving.pack"].counters["pinned_bytes"] == data.size
    assert got["serving.stage_in"].counters["adopted_bytes"] == data.size
    assert "copy_bytes" not in got["serving.unpack"].counters
