"""The port's scenario reports against the reference's with the engine
toggles the reference pins flipped away from their defaults (`wave`,
`candidate_cache`, `wave_complete` off, `calendar_queue` on; the reference
pins each in its own parity test), on three scenarios that exercise a rail
flap, HiCache promotion and a closed serving loop. Bit for bit.
`jit_core` on is held against the reference's jit-off reports over the
whole library (the reference's own jitted core does not import under this
jax), with the port's core on the CPU: the kernels' plain versions."""
import dataclasses

import pytest

import repro.scenarios as ref
import repro_torch.scenarios as port

TOGGLE_SCENARIOS = ["single_rail_flap", "hicache_serve", "serving_closed_loop_flap"]
TOGGLES = [("wave", False), ("candidate_cache", False), ("wave_complete", False),
           ("calendar_queue", True)]


@pytest.mark.parametrize("field,value", TOGGLES)
@pytest.mark.parametrize("name", TOGGLE_SCENARIOS)
def test_toggled_report_matches_reference(name, field, value):
    spec = ref.get(name)
    spec = dataclasses.replace(spec, engine=dataclasses.replace(spec.engine, **{field: value}))
    want = ref.ScenarioRunner(spec).run().to_dict()
    got = port.ScenarioRunner(port.ScenarioSpec.from_json(spec.to_json())).run().to_dict()
    assert got["policies"] == want["policies"]


@pytest.mark.parametrize("name", ref.names())
def test_jit_core_report_matches_reference(name):
    spec = ref.get(name)
    want = ref.ScenarioRunner(spec).run().to_dict()
    on = port.ScenarioSpec.from_json(spec.to_json())
    on = dataclasses.replace(on, engine=dataclasses.replace(on.engine, jit_core=True))
    got = port.ScenarioRunner(on, device="cpu").run().to_dict()
    assert got["policies"] == want["policies"]
