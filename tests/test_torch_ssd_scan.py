"""The port's SSD scan against the reference's, on the CPU.

On CPU tensors the port's wrapper runs its plain version (the step-by-step
recurrence); the Hopper kernel itself is held against that plain version
on the card by `chip_smoke.py`. The reference's wrapper runs its Pallas
kernel in interpret mode here. Inputs are made with numpy from a seed, at
the reference's own scales (tests/test_kernels.py). Tolerances are the
reference's kernel bar: 2e-3 in float32, 2e-2 in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_chunked as ref_ssd_kernel
from repro.kernels.ssd_scan import ssd_scan_ref as ref_scan_plain
from repro.models import ssm as ref_ssm
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.models import ssm

TOL = {"float32": dict(rtol=2e-3, atol=2e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# the reference's three kernel shapes (tests/test_kernels.py), S=100 padded
SHAPES = [
    (1, 128, 2, 16, 32, 32),
    (2, 256, 4, 64, 128, 64),
    (1, 100, 2, 16, 32, 32),
]


def _inputs(seed, B, S, H, P, N, with_state=False):
    rng = np.random.default_rng(seed)
    out = [(rng.standard_normal((B, S, H, P), dtype=np.float32) * 0.5),
           (-np.abs(rng.standard_normal((B, S, H), dtype=np.float32)) * 0.3),
           (rng.standard_normal((B, S, N), dtype=np.float32) * 0.5),
           (rng.standard_normal((B, S, N), dtype=np.float32) * 0.5)]
    if with_state:
        out.append(rng.standard_normal((B, H, P, N), dtype=np.float32))
    return out


def _both(arrays, dtype="float32"):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_wrapper_on_cpu_matches_reference_kernel(B, S, H, P, N, chunk):
    (jx, ja, jb, jc), (tx, ta, tb, tc) = _both(_inputs(0, B, S, H, P, N))
    want_y, want_fin = ref_ssd_kernel(jx, ja, jb, jc, chunk=chunk)
    before = ssd_kernel.launches
    got_y, got_fin = ssd_chunked(tx, ta, tb, tc, chunk=chunk)
    assert ssd_kernel.launches == before  # the plain version launches nothing
    assert got_y.shape == (B, S, H, P) and got_fin.shape == (B, H, P, N)
    assert got_y.dtype == got_fin.dtype == torch.float32
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL["float32"])
    np.testing.assert_allclose(_np(got_fin), _np(want_fin), **TOL["float32"])


def test_wrapper_initial_state_matches_reference_kernel():
    (jx, ja, jb, jc, js), (tx, ta, tb, tc, ts) = _both(_inputs(1, 1, 64, 2, 16, 32, True))
    want_y, want_fin = ref_ssd_kernel(jx, ja, jb, jc, chunk=32, initial_state=js)
    got_y, got_fin = ssd_chunked(tx, ta, tb, tc, chunk=32, initial_state=ts)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL["float32"])
    np.testing.assert_allclose(_np(got_fin), _np(want_fin), **TOL["float32"])


def test_wrapper_bf16_matches_reference_kernel():
    """bf16 in, bf16 out: y and the final state both come back in x's dtype."""
    (jx, ja, jb, jc), (tx, ta, tb, tc) = _both(_inputs(2, 1, 128, 2, 16, 32), "bfloat16")
    want_y, want_fin = ref_ssd_kernel(jx, ja, jb, jc, chunk=32)
    got_y, got_fin = ssd_chunked(tx, ta, tb, tc, chunk=32)
    assert got_y.dtype == got_fin.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL["bfloat16"])
    np.testing.assert_allclose(_np(got_fin), _np(want_fin), **TOL["bfloat16"])


@pytest.mark.parametrize("with_state", [False, True])
def test_plain_scan_matches_reference_plain(with_state):
    """The port's plain version against the reference's, fp32 state out."""
    arrays = _inputs(3, 2, 40, 3, 16, 8, with_state)
    jin, tin = _both(arrays)
    want_y, want_fin = ref_scan_plain(*jin)
    got_y, got_fin = ssd_scan_ref(*tin)
    assert got_fin.dtype == torch.float32
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL["float32"])
    np.testing.assert_allclose(_np(got_fin), _np(want_fin), **TOL["float32"])


@pytest.mark.parametrize("S,chunk", [(128, 32), (100, 32), (24, 128)])
@pytest.mark.parametrize("with_state", [False, True])
def test_model_ssd_chunked_matches_reference(S, chunk, with_state):
    """`models/ssm.py::ssd_chunked`, the plain chunked einsum form, against
    the reference's, S=100 through the identity-step padding and S=24
    through the chunk = min(chunk, S) rule."""
    jin, tin = _both(_inputs(4, 2, S, 2, 32, 64, with_state))
    jkw = {"initial_state": jin.pop()} if with_state else {}
    tkw = {"initial_state": tin.pop()} if with_state else {}
    want_y, want_fin = ref_ssm.ssd_chunked(*jin, chunk=chunk, **jkw)
    got_y, got_fin = ssm.ssd_chunked(*tin, chunk=chunk, **tkw)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL["float32"])
    np.testing.assert_allclose(_np(got_fin), _np(want_fin), **TOL["float32"])


def test_model_ssd_chunked_dispatches_to_the_wrapper():
    """use_pallas=True goes through the kernel wrapper (its plain version
    on the CPU) and agrees with the chunked form."""
    _, tin = _both(_inputs(5, 1, 100, 2, 16, 32))
    got = ssm.ssd_chunked(*tin, chunk=32, use_pallas=True)
    want = ssm.ssd_chunked(*tin, chunk=32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL["float32"])


def test_model_recurrent_ref_and_step_match_reference():
    jin, tin = _both(_inputs(6, 2, 24, 2, 16, 16, True))
    want_y, want_fin = ref_ssm.ssd_recurrent_ref(*jin)
    got_y, got_fin = ssm.ssd_recurrent_ref(*tin)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL["float32"])
    np.testing.assert_allclose(_np(got_fin), _np(want_fin), **TOL["float32"])
    (jx, ja, jb, jc, js), (tx, ta, tb, tc, ts) = jin, tin
    want_st, want_yt = ref_ssm.ssd_step(js, jx[:, 0], ja[:, 0], jb[:, 0], jc[:, 0])
    got_st, got_yt = ssm.ssd_step(ts, tx[:, 0], ta[:, 0], tb[:, 0], tc[:, 0])
    np.testing.assert_allclose(_np(got_st), _np(want_st), **TOL["float32"])
    np.testing.assert_allclose(_np(got_yt), _np(want_yt), **TOL["float32"])


def test_segsum_matches_reference():
    a = -np.abs(np.random.default_rng(7).standard_normal((2, 3, 16), dtype=np.float32))
    want = np.asarray(ref_ssm.segsum(jnp.asarray(a)))
    got = ssm.segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], **TOL["float32"])


def test_kernel_entry_refuses_cpu_tensors():
    """No plain-version fallback hides behind the kernel's entry point."""
    tx, ta, tb, tc = (torch.from_numpy(a) for a in _inputs(8, 1, 64, 2, 16, 32))
    before = ssd_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(tx, ta, tb, tc, chunk=32)
    assert ssd_kernel.launches == before


def test_twin_registry_names_the_plain_version():
    assert ssd_kernel.__torch_twins__ == {"ssd_scan": ssd_scan_ref}
