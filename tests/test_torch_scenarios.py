"""The port's scenario runner against the reference's, report for report.

For every single-engine scenario of the library (the production stream
has its own file, the cluster scenarios theirs), the port's
`ScenarioReport.to_dict()["policies"]` equals the reference's exactly: the
host engine, serving, HiCache and checkpoint layers are float64 numpy in
both packages, so the bar is bit-identity. The spec crosses between the
packages as JSON. The engine toggles, `jit_core` among them, are checked
in `test_torch_scenario_toggles.py`.
"""
import dataclasses

import pytest
import torch

import repro.scenarios as ref
import repro_torch.scenarios as port

STREAM = "serving_production_stream"
SINGLE = [n for n in ref.names()
          if not isinstance(ref.get(n).workload, ref.ClusterWorkload) and n != STREAM]


def _port_spec(ref_spec):
    """The port's counterpart of a reference spec: through its JSON."""
    return port.ScenarioSpec.from_json(ref_spec.to_json())


def _reports(ref_spec):
    want = ref.ScenarioRunner(ref_spec).run().to_dict()
    got = port.ScenarioRunner(_port_spec(ref_spec)).run().to_dict()
    return got, want


def test_library_names_match():
    assert port.names() == ref.names()
    assert len(port.names()) == 25


@pytest.mark.parametrize("name", ref.names())
def test_spec_round_trip_between_packages(name):
    spec = _port_spec(ref.get(name))
    assert spec == port.get(name)
    assert spec.to_dict() == ref.get(name).to_dict()


@pytest.mark.parametrize("name", SINGLE)
def test_report_matches_reference(name):
    got, want = _reports(ref.get(name))
    assert got["policies"] == want["policies"]
    assert got["violations"] == want["violations"] == []
    assert got["spec"] == want["spec"]


def test_jit_core_is_refused(monkeypatch):
    """The jitted core runs on the card unless the caller asks for the CPU:
    without a card, jit_core is refused, never run quietly on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = port.get("single_rail_flap")
    spec = dataclasses.replace(spec, engine=dataclasses.replace(spec.engine, jit_core=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.ScenarioRunner(spec).run_policy("tent")
    on_cpu = port.ScenarioRunner(spec, device="cpu").run_policy("tent").to_dict()
    assert on_cpu == port.ScenarioRunner(port.get("single_rail_flap")).run_policy(
        "tent").to_dict()


def test_sanitized_run_matches(monkeypatch):
    """Under REPRO_SANITIZE=1 the port's runner patches the wall clock and
    the global RNGs for its own modules, and the report does not move."""
    plain = port.ScenarioRunner(port.get("single_rail_flap")).run().to_dict()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    sanitized = port.ScenarioRunner(port.get("single_rail_flap")).run().to_dict()
    assert sanitized["policies"] == plain["policies"]
