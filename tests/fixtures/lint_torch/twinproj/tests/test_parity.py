"""Parity tests for the twinproj fixture (textual references are what the
twin-drift rule checks for)."""
from ..pkg.kernel import bare_waiver, by_string, chained, drifted, good, scale_torch, waived
from ..pkg.ops import packaged
from ..pkg.ref import chained_ref, drifted_ref, good_ref, scale, waived_ref


def test_pairs():
    assert good(2.0, 3.0) == good_ref(2.0, 3.0) == packaged(2.0, 3.0) == by_string(2.0, 3.0)
    assert chained(1.0) == chained_ref(1.0)
    assert drifted(1.0, 0.5) == drifted_ref(1.0, 0.5)
    assert waived([1, 2], 1) == waived_ref([1, 2], 1) == bare_waiver([1])
    assert scale_torch(2.0, 3.0) == scale(2.0, 3.0)
