"""Reads in place where no writer can follow the read (`Segment.view`,
`Segment.read_in_place`, the engine's slice copy), on the CPU.

A landed handoff's view reads the destination's own bytes; a registered
segment's read stays a copy; a range across two buffers is copied byte for
byte; a slice reads its source in place and copies once, under the rail
flap's retries too; a transfer within one segment over overlapping ranges
lands as the copying path lands it. The test marked `card` crosses a landed
view to an NVIDIA card from pinned memory; it skips without one
(`python -m pytest -m card tests/test_torch_inplace_reads.py`).
"""
import warnings

import numpy as np
import pytest
import torch

from pd_handoff import pd_engine, ship
from repro_torch.core import Location, MemoryKind, SegmentManager
from repro_torch.core.segments import Segment
from repro_torch.obs import spans
from repro_torch.serving import bytes_to_tree, tree_to_bytes

HOST = Location(node=0, kind=MemoryKind.HOST_DRAM, device=0, numa=0)
GPU0 = Location(node=0, kind=MemoryKind.DEVICE_HBM, device=0, numa=0)


@pytest.fixture
def recorder():
    rec = spans.attach()
    yield rec
    spans.detach()


def _data(n: int, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def test_a_landed_view_reads_the_destination_in_place(recorder):
    data = _data(1 << 20)
    with recorder.request(keep=True) as root:
        dst, res = ship(pd_engine(), data)
        landed = dst.buffers[0].data
        got = dst.read(0, data.size)
        part = dst.read(4096, 1000)
    assert res.ok
    assert np.shares_memory(got, landed) and np.shares_memory(part, landed)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(part, data[4096:5096])
    assert root.counters["inplace_bytes"] == data.size + 1000
    assert "copy_bytes" not in root.counters


def test_a_registered_segment_reads_a_copy():
    mgr = SegmentManager()
    init = _data(8192)
    seg = mgr.register(HOST, init.size, init=init)
    got = seg.read(100, 500)
    assert not np.shares_memory(got, seg.buffers[0].data)
    got[:] = 0
    np.testing.assert_array_equal(seg.read(0, init.size), init)
    # `read_in_place` does alias it, for a caller no writer can follow
    assert np.shares_memory(seg.read_in_place(100, 500), seg.buffers[0].data)


@pytest.mark.parametrize("offset,length", [(3000, 5000), (0, 8192), (4095, 2)],
                         ids=["middle", "whole", "seam"])
def test_a_range_across_two_buffers_is_copied_byte_exact(recorder, offset, length):
    init = _data(8192, seed=9)
    seg = SegmentManager().register(HOST, init.size, init=init, n_buffers=2)
    view = seg.view()
    with recorder.request(keep=True) as root:
        got = view.read(offset, length)
        inside = view.read(4096, 100)
    np.testing.assert_array_equal(got, init[offset:offset + length])
    assert not any(np.shares_memory(got, b.data) for b in seg.buffers)
    assert np.shares_memory(inside, seg.buffers[1].data)
    assert root.counters["copy_bytes"] == length
    assert root.counters["inplace_bytes"] == 100


def test_a_phantom_view_reads_zeros():
    seg = SegmentManager().register(HOST, 4096, materialize=False)
    got = seg.view().read_in_place(10, 100)
    assert got.shape == (100,) and not got.any()


def test_a_flapped_handoff_with_retried_slices_lands_byte_for_byte(recorder):
    data = _data(16 << 20, seed=3)
    eng = pd_engine()
    with recorder.request(keep=True) as root:
        dst, res = ship(eng, data, flap=True)
    assert res.ok and eng.slices_retried > 0
    np.testing.assert_array_equal(dst.read(0, data.size), data)
    run = next(s for s in recorder.take(root.request) if s.name == "engine.run")
    # a retried slice's bytes land once: only the slice that completes writes
    assert run.counters["copy_bytes"] == run.counters["inplace_bytes"] == data.size


@pytest.mark.parametrize("n_buffers", [1, 2, 3])
@pytest.mark.parametrize("src,dst,n", [
    (0, 300_000, 900_000), (300_000, 0, 900_000), (0, 1_000_000, 900_000),
    (450_000, 550_000, 900_000), (450_000, 460_000, 900_000), (460_000, 450_000, 900_000)],
    ids=["forward", "backward", "apart", "seam", "near_forward", "near_backward"])
def test_a_transfer_within_one_segment_lands_as_the_copying_path(monkeypatch, n_buffers,
                                                                  src, dst, n):
    """Overlapping ranges of one segment, over one buffer and across the
    seams of two and three: the in-place path lands the bytes the copying
    read lands, slice order and all."""
    init = _data(2_000_000, seed=5)
    landed = []
    for in_place in (True, False):
        eng = pd_engine()
        if not in_place:
            monkeypatch.setattr(Segment, "read_in_place", Segment.read)
        seg = eng.register_segment(GPU0, init.size, init=init, n_buffers=n_buffers)
        res = eng.transfer_sync(seg.segment_id, src, seg.segment_id, dst, n)
        assert res.ok
        landed.append(np.concatenate([b.data for b in seg.buffers]))
    np.testing.assert_array_equal(landed[0], landed[1])
    if not (src < dst + n and dst < src + n):
        want = init.copy()
        want[dst:dst + n] = init[src:src + n]
        np.testing.assert_array_equal(landed[0], want)


def test_count_adds_to_the_innermost_span_and_times_nothing(recorder):
    with recorder.request(keep=True) as root:
        with recorder.span("inner") as inner:
            recorder.count("inplace_bytes", 5)
            recorder.count("inplace_bytes", 7)
        recorder.count("inplace_bytes", 1)
    assert inner.counters == {"inplace_bytes": 12}
    assert root.counters == {"inplace_bytes": 1}
    recorder.take(root.request)
    recorder.count("inplace_bytes", 3)  # nothing open: dropped
    assert recorder._open == []


@pytest.mark.card
def test_a_landed_view_crosses_to_the_card_from_pinned_memory(recorder):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(5)
    tree = {"a": torch.randn(3, 5, 7, generator=g).to(torch.bfloat16).to(dev),
            "b": torch.randn(1 << 18, generator=g).to(dev),
            "c": torch.randn(13, generator=g).to(torch.bfloat16).to(dev)}
    with recorder.request(keep=True) as root:
        data, _ = tree_to_bytes(tree)
        dst, res = ship(pd_engine(), data, params={"w": torch.zeros(1, device=dev)})
        got = dst.read(0, data.size)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            flat = torch.from_numpy(got)
            back = bytes_to_tree(got, tree)
    assert res.ok
    assert flat.is_pinned() and np.shares_memory(got, dst.buffers[0].data)
    for k in tree:
        assert back[k].device == dev and back[k].dtype == tree[k].dtype
        assert torch.equal(back[k].view(torch.uint8), tree[k].view(torch.uint8))
    spans_ = {s.name: s for s in recorder.take(root.request)}
    assert "copy_bytes" not in spans_["serving.unpack"].counters
    assert spans_[spans.REQUEST].counters["inplace_bytes"] == data.size
    assert spans_["engine.run"].counters["copy_bytes"] == data.size
