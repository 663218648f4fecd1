"""`program_spans`: the port's own spans in a run of a cell, on the CPU at
the smoke sizes."""
import pytest
import torch
from conftest import CELLS
from torch.profiler import ProfilerActivity, profile

from tentbench import harness, program_spans
from tentbench.generator import Prompts
from tentbench.tracing import Spans

# the harness span each program span runs in
HOME = {"model.prefill": "prefill", "serving.pack": "pack", "serving.register": "engine",
        "serving.stage_in": "engine", "engine.submit": "engine", "engine.run": "engine",
        "serving.unpack": "unpack", "model.decode_step": "decode"}


def _ranges(prof, prefix):
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(prefix):])
            for e in prof.profiler.kineto_results.events() if e.name().startswith(prefix)]


@pytest.mark.parametrize("name", CELLS)
def test_every_program_range_lies_inside_its_harness_range(smoke_cell, name):
    from repro_torch.obs import spans

    cell = smoke_cell(name)
    params = cell.family.make_params(cell.conf, torch.Generator().manual_seed(1), cell.dtype)
    prog = harness.Program(cell, params, torch.device("cpu"))
    tokens = Prompts(7, harness.PROMPTS, int(cell.conf["vocab_size"]), torch.device("cpu")).draw(
        cell.traffic.batch, cell.traffic.shapes()[0])
    spans.attach()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with spans.request():
                assert prog.serve(tokens, cell.traffic.n_new, Spans(True)).ok
    finally:
        spans.detach()
    tent, tb = _ranges(prof, "tent."), _ranges(prof, "tb.")
    assert {n for *_, n in tent} == set(HOME) | {"serve.request"}
    for s, e, n in tent:
        if n != "serve.request":
            assert any(s0 <= s and e <= e0 for s0, e0, home in tb if home == HOME[n]), n


def _run(cell, record: bool, calls: int = 3) -> harness.Run:
    """A run of `calls` calls of the cell's first shape, each served inside a
    kept request whose spans land on `Call.program` when `record`."""
    from repro_torch.obs import spans

    params = cell.family.make_params(cell.conf, torch.Generator().manual_seed(1), cell.dtype)
    prog = harness.Program(cell, params, torch.device("cpu"))
    prompts = Prompts(7, harness.PROMPTS, int(cell.conf["vocab_size"]), torch.device("cpu"))
    done = []
    rec = spans.attach() if record else None
    try:
        for _ in range(calls):
            tokens = prompts.draw(cell.traffic.batch, cell.traffic.shapes()[0])
            if rec is None:
                call = prog.serve(tokens, cell.traffic.n_new, Spans(False))
            else:
                with rec.request(keep=True) as root:
                    call = prog.serve(tokens, cell.traffic.n_new, Spans(False))
                call.program = rec.take(root.request)
            assert call.ok
            done.append(call)
    finally:
        spans.detach()
    return harness.Run(cell=cell, calls=done, window_s=1.0, setup_s=0.0)


def test_recorded_calls_read_five_copies_and_parts_inside_the_engine_span(smoke_cell):
    run = _run(smoke_cell("qwen2-0.5b.pd_ttft"), record=True)
    assert program_spans.copy_amp(run) == 5.0
    for c in run.calls:
        parts = program_spans.parts_ns(c.program)
        assert all(v >= 0 for v in parts.values())
        assert sum(parts.values()) <= c.spans["engine"] * 1e9
    for name, read in program_spans.READERS.items():
        assert (read(run) is None) == (name == "decode_launches"), name
    means = program_spans.span_means_ms(run.calls)
    assert {"engine.run", "serving.stage_in", "model.decode_step"} <= set(means)


def test_segments_live_reads_the_last_register_span(smoke_cell):
    """Two segments a handoff, never freed: the last call's register span
    counts every call's."""
    run = _run(smoke_cell("mamba2-370m.pd_ttft"), record=True)
    live = program_spans.segments_live(run.calls)
    assert live["segments_live"] == 2 * len(run.calls)
    assert live["segment_bytes_live"] == 2 * sum(c.kv_bytes for c in run.calls)


def test_readers_return_none_for_a_run_without_program_spans(smoke_cell):
    run = _run(smoke_cell("mamba2-370m.decode_batch"), record=False, calls=1)
    assert run.calls and not any(getattr(c, "program", None) for c in run.calls)
    for read in list(program_spans.READERS.values()) + [program_spans.idle_by_program_span]:
        assert read(run) is None
    assert program_spans.segments_live(run.calls) is None
    assert program_spans.read_program_trace([]) is None


class _Event:
    """A kineto event as `read_program_trace` reads one."""

    def __init__(self, name, start, end, cuda=False):
        from torch.autograd import DeviceType

        self._name, self._start, self._dur = name, start, end - start
        self._dev = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return False


def test_idle_gaps_are_split_over_the_innermost_ranges_and_launches_counted():
    """A window 0-100: the card busy 0-10 and 90-100; tb.engine 0-60 holds
    tent.engine.run 20-50, tb.unpack 60-100 holds tent.serving.unpack 60-80;
    two decode steps launch 3 and 1 kernels."""
    ev = [_Event("tb.engine", 0, 60), _Event("tb.unpack", 60, 100),
          _Event("tent.serve.request", 0, 100), _Event("tent.engine.run", 20, 50),
          _Event("tent.serving.unpack", 60, 80),
          _Event("k", 0, 10, cuda=True), _Event("k", 90, 100, cuda=True),
          _Event("tent.model.decode_step", 1000, 1010), _Event("tent.model.decode_step", 1020, 1030)]
    ev += [_Event("cudaLaunchKernel", t, t + 1) for t in (1001, 1002, 1003, 1021, 1040)]
    out = program_spans.read_program_trace(ev)
    assert out["decode_launches"] == 2.0
    idle = {k: round(v * 1e9) for k, v in out["idle_by_program_span"].items()}
    assert idle == {"engine.run": 30, "serve.request": 10 + 10 + 10, "serving.unpack": 20}
    pairs = {k: round(v * 1e9) for k, v in out["idle_by_harness_and_program_span"].items()}
    assert pairs == {"engine/engine.run": 30, "engine/serve.request": 20,
                     "unpack/serving.unpack": 20, "unpack/serve.request": 10}
