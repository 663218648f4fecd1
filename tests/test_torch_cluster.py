"""The port's cluster control plane against the reference's: the seven
multi-engine scenarios of the library (diffusion on and off, lossy gossip,
partial membership views, engine churn, trainer fan-out), report for
report, bit for bit."""
import pytest

import repro.scenarios as ref
import repro_torch.scenarios as port
from repro_torch.cluster import TentCluster

CLUSTER = [n for n in ref.names() if isinstance(ref.get(n).workload, ref.ClusterWorkload)]


def test_the_seven_cluster_scenarios():
    assert CLUSTER == sorted([
        "multi_engine_kv_incast", "multi_engine_incast_flap", "lossy_gossip_flap",
        "partial_view_incast", "engine_churn_diffusion", "churn_storm",
        "trainer_broadcast_fanout"])
    assert any("tent+diffusion" in ref.get(n).policies for n in CLUSTER)


@pytest.mark.parametrize("name", CLUSTER)
def test_cluster_report_matches_reference(name):
    ref_spec = ref.get(name)
    want = ref.ScenarioRunner(ref_spec).run().to_dict()
    runner = port.ScenarioRunner(port.ScenarioSpec.from_json(ref_spec.to_json()))
    got = runner.run().to_dict()
    assert got["policies"] == want["policies"]
    assert got["violations"] == want["violations"] == []
    assert set(got["policies"]) == set(ref_spec.policies)


def test_runner_builds_a_port_cluster():
    runner = port.ScenarioRunner(port.get("multi_engine_kv_incast"))
    cluster = runner.build_cluster("tent+diffusion")
    assert isinstance(cluster, TentCluster)
    assert len(cluster.engines) >= 2
    assert cluster.fabric is next(iter(cluster.engines.values())).fabric  # one shared clock
