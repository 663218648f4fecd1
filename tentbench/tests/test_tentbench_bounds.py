"""The frozen operation and byte counts give the bounds PERF.md's kernel
table states at its shapes, and the shares built on them stay below 100 %."""
import importlib.util

import pytest
import torch
from conftest import ROOT

from tentbench import readers


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tentbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("shape,dtype,window,ms", [
    ((4, 1024, 14, 2, 64), F32, 0, 0.1123), ((4, 1024, 14, 2, 64), BF16, 0, 0.0076),
    ((2, 3072, 25, 5, 64), F32, 2048, 0.8015), ((2, 3072, 25, 5, 64), BF16, 2048, 0.0543),
    ((4, 1024, 64, 4, 128), F32, 0, 1.0267), ((4, 1024, 64, 4, 128), BF16, 0, 0.0696),
    ((4, 1024, 16, 16, 64), F32, 0, 0.1283), ((4, 1024, 16, 16, 64), BF16, 0, 0.0100),
])
def test_flash_bound_matches_the_kernel_table(shape, dtype, window, ms):
    got, _ = _reader("flash_roofline_pct").flash_bound(*shape, dtype, window)
    assert round(got, 4) == ms


@pytest.mark.parametrize("shape,dtype,ms,by", [
    ((4, 1024, 32, 64, 128, 128), F32, 0.0813, "operations"),
    ((4, 1024, 32, 64, 128, 128), BF16, 0.0120, "bytes"),
    ((2, 3072, 50, 64, 16, 128), F32, 0.0568, None),
    ((2, 3072, 50, 64, 16, 128), BF16, 0.0239, None),
])
def test_ssd_bound_matches_the_kernel_table(shape, dtype, ms, by):
    got, bound_by = _reader("ssd_roofline_pct").ssd_bound(*shape, dtype)
    assert round(got, 4) == ms and by in (None, bound_by)


class _Trace:
    def __init__(self, ranges):
        self.ranges = ranges


class _Run:
    def __init__(self, calls, ranges):
        self.op_calls, self.trace = {"attention": calls}, _Trace({"attention": ranges})


def test_roofline_leaves_out_calls_missing_a_record_and_never_makes_one_up():
    shape = (1, 1024, 14, 2, 64, BF16, 0)
    bound_ms = _reader("flash_roofline_pct").flash_bound(*shape)[0]
    run = _Run([shape] * 3, [(int(4 * bound_ms * 1e6), 1), (int(4 * bound_ms * 1e6), 1), (0, 0)])
    got = readers.roofline_pct(run, "attention", lambda s: bound_ms)
    assert got == pytest.approx(25.0, rel=1e-4)
    assert readers.roofline_pct(_Run([shape], [(0, 0)]), "attention", lambda s: 1.0) is None
    assert readers.roofline_pct(_Run([shape] * 2, [(5, 1)]), "attention", lambda s: 1.0) is None
