"""The port's observability layer (`repro_torch.obs`) against the reference's.

The flight recorder, the Chrome-trace exporter and the explain tools are
the reference's host code with the imports re-pointed, so the bar is
identity: a recorder never changes a report, the port's exported trace is
byte-equal to the reference's for the same scenario, `replay_wave`
reproduces every recorded wave (through the port's own `tent_choose_wave`
too) and catches a tampered one, and the trace-derived healing time equals
the report's stall number. Attaching a recorder to an engine whose jitted
core is on turns the core off with a warning and changes nothing.
"""
import contextlib
import dataclasses
import io
import json
import warnings

import numpy as np
import pytest

import repro.obs as ref_obs
import repro.scenarios as ref
import repro_torch.obs as port_obs
import repro_torch.scenarios as port
from repro_torch.core import EngineConfig, FabricSpec, TentEngine
from repro_torch.obs import FlightRecorder, export_chrome_trace, to_json, validate_trace
from repro_torch.obs import events as EV
from repro_torch.obs import explain
from repro_torch.obs.explain import healing_timeline, print_slice_chain, replay_wave, slice_chain


def _port_spec(name):
    return port.ScenarioSpec.from_json(ref.get(name).to_json())


def _run_recorded(name, policy=None, capacity=1 << 18, spec=None):
    spec = spec or _port_spec(name)
    rec = FlightRecorder(capacity=capacity)
    rep = port.ScenarioRunner(spec, device="cpu").run_policy(policy or spec.policies[0],
                                                             recorder=rec)
    return rec, rep


def _ref_trace(name, policy):
    rec = ref_obs.FlightRecorder(capacity=1 << 18)
    ref.ScenarioRunner(ref.get(name)).run_policy(policy, recorder=rec)
    return ref_obs.to_json(ref_obs.export_chrome_trace(rec))


@pytest.fixture(scope="module")
def incast_flap():
    """multi_engine_incast_flap under tent+diffusion, recorded by the port."""
    return _run_recorded("multi_engine_incast_flap", "tent+diffusion")


@pytest.fixture(scope="module")
def gossip_flap():
    return _run_recorded("lossy_gossip_flap", "tent+diffusion")


class _FakeSlice:
    def __init__(self, slice_id, batch_id, src_offset, length):
        self.slice_id = slice_id
        self.batch_id = batch_id
        self.src_offset = src_offset
        self.length = length


def test_obs_exports_what_the_reference_exports():
    assert sorted(port_obs.__all__) == sorted(ref_obs.__all__)


def test_ring_wraparound_drops_oldest():
    rec = FlightRecorder(capacity=4)
    for i in range(7):
        rec.append(EV.POST, float(i), {"i": i})
    assert len(rec) == 4 and rec.dropped == 3
    assert [pl["i"] for _, _, pl in rec.events()] == [3, 4, 5, 6]
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def test_lazy_interning_first_seen_order():
    rec = FlightRecorder()
    a, b = _FakeSlice(900, 70, 0, 64), _FakeSlice(905, 70, 64, 64)
    rec.append(EV.WAVE, 0.0, {"slices": [b, a]})
    rec.append(EV.POST, 1.0, {"slice": a})
    assert rec.n_slices() == 0  # nothing interned before a read
    evs = list(rec.events())
    assert evs[0][2]["slices"] == [0, 1] and evs[1][2]["slice"] == 1
    assert rec.slice_info(0) == (0, 64, 64) and rec.n_batches() == 1
    assert rec.counts() == {"wave": 1, "post": 1}


@pytest.mark.parametrize("name,policy", [("multi_engine_incast_flap", "tent+diffusion"),
                                         ("uniform_spray", "tent")])
def test_recorder_leaves_the_report_unchanged(name, policy, incast_flap):
    if name == "multi_engine_incast_flap":
        rec, rep_on = incast_flap
    else:
        rec, rep_on = _run_recorded(name, policy)
    rep_off = port.ScenarioRunner(_port_spec(name)).run_policy(policy)
    assert rep_on.to_dict() == rep_off.to_dict()
    assert rep_off.to_dict() == ref.ScenarioRunner(ref.get(name)).run_policy(policy).to_dict()
    assert len(rec) > 0


@pytest.mark.parametrize("name,policy", [("multi_engine_incast_flap", "tent+diffusion"),
                                         ("single_rail_flap", "tent")])
def test_trace_is_byte_equal_to_the_reference(name, policy, incast_flap):
    rec = incast_flap[0] if name == "multi_engine_incast_flap" else _run_recorded(name, policy)[0]
    doc = export_chrome_trace(rec)
    assert validate_trace(doc) == []
    assert to_json(doc) == _ref_trace(name, policy)


def test_trace_schema_round_trips(incast_flap):
    parsed = json.loads(to_json(export_chrome_trace(incast_flap[0])))
    assert parsed["displayTimeUnit"] == "ms" and parsed["otherData"]["dropped"] == 0
    evs = parsed["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    assert any(e["ph"] == "X" and e["dur"] >= 0 for e in evs)


@pytest.mark.parametrize("fixture", ["incast_flap", "gossip_flap"])
def test_every_wave_replays_to_recorded_choices(fixture, request):
    rec, _ = request.getfixturevalue(fixture)
    waves = [pl for _, k, pl in rec.events() if k == EV.WAVE]
    assert waves
    for pl in waves:
        rows = replay_wave(pl)  # raises ProvenanceError on divergence
        assert len(rows) == len(pl["slices"])
        for row in rows:
            if not row["infeasible"]:
                assert len(row["scores"]) == len(pl["inputs"]["queued"])
                assert row["chosen"] in row["window"] or row["fallback"]


def test_replay_detects_tampering(incast_flap):
    rec, _ = incast_flap
    pl = next(pl for _, k, pl in rec.events() if k == EV.WAVE and len(pl["slices"]) > 0)
    bad = dict(pl)
    choices = np.array(pl["choices"], copy=True)
    choices[0] = (int(choices[0]) + 1) % len(pl["inputs"]["queued"])
    bad["choices"] = choices
    with pytest.raises(explain.ProvenanceError):
        replay_wave(bad)


@pytest.mark.parametrize("fixture", ["incast_flap", "gossip_flap"])
def test_trace_heal_equals_stall_matrix(fixture, request):
    rec, rep = request.getfixturevalue(fixture)
    h = healing_timeline(list(rec.events()), exclude_engines=("cache",))
    assert h["heal_ms"] == rep.stall_ms  # exact: the same float operations
    assert h["heal_ms"] < 50.0
    assert h["onsets"] and h["first_failure"] >= h["onsets"][0]
    assert healing_timeline([])["heal_ms"] == -1.0


def test_slice_chains(incast_flap):
    rec, _ = incast_flap
    events = list(rec.events())
    sid = next(pl["slices"][0] for _, k, pl in events if k == EV.WAVE)
    steps = [s for _, s, _ in slice_chain(rec, events, sid)]
    assert {"intent", "wave", "complete"} <= set(steps)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_slice_chain(rec, events, sid)
    assert f"slice {sid}" in buf.getvalue() and "wave pick" in buf.getvalue()
    fails = [pl["slice"] for _, k, pl in events if k == EV.FAIL]
    assert fails
    fail_steps = [s for _, s, _ in slice_chain(rec, events, fails[0])]
    assert "fail" in fail_steps and ("reroute" in fail_steps or "substitute" in fail_steps)


def test_explain_cli_prints_what_the_reference_prints(tmp_path, capsys):
    trace = tmp_path / "t.json"
    assert explain.main(["--scenario", "uniform_spray", "--slice", "0", "--healing",
                         "--trace-out", str(trace)]) == 0
    got = capsys.readouterr().out
    ref_trace = tmp_path / "r.json"
    from repro.obs import explain as ref_explain

    assert ref_explain.main(["--scenario", "uniform_spray", "--slice", "0", "--healing",
                             "--trace-out", str(ref_trace)]) == 0
    want = capsys.readouterr().out
    assert got.replace(str(trace), "T") == want.replace(str(ref_trace), "T")
    assert "slice 0" in got
    assert trace.read_bytes() == ref_trace.read_bytes()
    assert validate_trace(json.loads(trace.read_text())) == []


def test_attach_recorder_turns_the_jitted_core_off():
    eng = TentEngine(FabricSpec(n_nodes=2), config=EngineConfig(jit_core=True), seed=3,
                     device="cpu")
    assert eng._jit is not None
    with pytest.warns(RuntimeWarning, match="disabling the jitted core"):
        eng.attach_recorder(FlightRecorder())
    assert eng._jit is None


def test_recorded_jit_run_matches_the_unrecorded_runs():
    """recorder + jit_core: the host path, and the report byte-identical to
    the unrecorded jit run and to the reference's jit-off run."""
    spec = _port_spec("single_rail_flap")
    jit_spec = dataclasses.replace(spec, engine=dataclasses.replace(spec.engine, jit_core=True))
    with pytest.warns(RuntimeWarning, match="disabling the jitted core"):
        rec, rep_on = _run_recorded("single_rail_flap", "tent", spec=jit_spec)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # an unrecorded jit run stays silent
        rep_jit = port.ScenarioRunner(jit_spec, device="cpu").run_policy("tent")
    assert rep_on.to_dict() == rep_jit.to_dict()
    assert rep_on.to_dict() == ref.ScenarioRunner(ref.get("single_rail_flap")).run_policy(
        "tent").to_dict()
    assert len(rec) > 0
