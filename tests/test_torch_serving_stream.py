"""The port's production serving stream against the reference's, at full
size: 10^5 Zipf/Poisson requests through the batched struct-of-arrays
stepper and the calendar-queue fabric, with two mid-stream brownouts. The
two packages' reports are equal bit for bit."""
import repro.scenarios as ref
import repro_torch.scenarios as port

NAME = "serving_production_stream"


def test_production_stream_matches_reference():
    ref_spec = ref.get(NAME)
    want = ref.ScenarioRunner(ref_spec).run().to_dict()
    got = port.ScenarioRunner(port.ScenarioSpec.from_json(ref_spec.to_json())).run().to_dict()
    assert got["policies"] == want["policies"]
    assert got["violations"] == want["violations"] == []
    tent, rr = got["policies"]["tent"], got["policies"]["round_robin"]
    assert tent["throughput"] > rr["throughput"]
