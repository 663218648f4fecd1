"""The port's SSD scan against the reference's, on the CPU.

On CPU tensors the port's wrapper runs its plain version (the step-by-step
recurrence); the Hopper kernel itself is held against that plain version
on the card by `chip_smoke.py`. The reference's wrapper runs its Pallas
kernel in interpret mode here. Inputs are made with numpy from a seed, at
the reference's own scales (tests/test_kernels.py). Tolerances are the
reference's kernel bar: 2e-3 in float32, 2e-2 in bfloat16.

The kernel splits the scan into three chunk-parallel phases and, in bf16,
rounds in places the plain version does not, so this file also keeps a
plain-torch emulation of the three phases with those rounding points
(`kernel_emulation`, never on the main path), holds it against the
reference's Pallas kernel and chunked form, and `tests/test_torch_ssm.py`
rehearses `chip_smoke.py`'s mamba2 bf16 serving gate with it.
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


# the kernel's phases at the wrapper's chunk rule: (B, S, H, P, N, chunk)
# with N = 128 and L = 128, N = 16 with several heads, a ragged S = 100,
# S = 5 (chunk 8), S = 40 (chunk 64), and an initial state
EMULATION_CASES = [
    ((2, 256, 4, 64, 128, 128), False),
    ((2, 128, 6, 64, 16, 64), False),
    ((1, 100, 3, 32, 64, 128), False),
    ((2, 5, 2, 16, 32, 128), False),
    ((1, 40, 3, 64, 128, 128), False),
    ((1, 192, 2, 64, 128, 64), True),
]


def _bf16_pair(t):
    """t as the kernel hands it to wgmma: bf16(t) + bf16(t - bf16(t)),
    exact in fp32."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float()


def kernel_emulation(x, a, B_in, C_in, *, chunk, initial_state=None):
    """The three-phase kernel's arithmetic in plain torch (csrc/ssd_scan.cu):
    per chunk of `chunk` steps (the last one padded with identity steps),
    a_cs in fp32; chunk_state S_c = (x . exp(a_cs[-1] - a_cs))^T B and the
    chunk decay exp(a_cs[-1]); state_pass carry = carry * decay + S_c, the
    entering states kept; chunk_scan y = exp(a_cs) (C prev^T) + ((C B^T) o
    exp(segsum)) x, the exponential only on and below the diagonal. For
    bf16 inputs x . decay, the entering state and the decayed scores go to
    the tensor cores as bf16 pairs, v = hi + lo with hi = bf16(v) and
    lo = bf16(v - hi) (about 16 bits of v); every product accumulates in
    fp32. Returns y in x's dtype and the final state in fp32, as the kernel
    does."""
    b, s, h, p = x.shape
    n = B_in.shape[-1]
    L = chunk
    nc = -(-s // L)
    pad = nc * L - s
    rnd = _bf16_pair if x.dtype == torch.bfloat16 else (lambda t: t)
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    af = torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(B_in.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C_in.float(), (0, 0, 0, pad))
    xc = xf.reshape(b, nc, L, h, p)
    Bc, Cc = Bf.reshape(b, nc, L, n), Cf.reshape(b, nc, L, n)
    a_cs = torch.cumsum(af.reshape(b, nc, L, h).permute(0, 3, 1, 2), dim=-1)  # (b,h,c,l)
    # chunk_state
    de = torch.exp(a_cs[..., -1:] - a_cs).permute(0, 2, 3, 1)  # (b,c,l,h)
    own = torch.einsum("bclhp,bcln->bhcpn", rnd(xc * de[..., None]), Bc)
    decay = torch.exp(a_cs[..., -1])  # (b,h,c)
    # state_pass
    carry = (torch.zeros((b, h, p, n)) if initial_state is None else initial_state.float())
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * decay[:, :, c, None, None] + own[:, :, c]
    prev = rnd(torch.stack(entering, dim=2))  # (b,h,c,p,n)
    # chunk_scan
    inter = torch.einsum("bcln,bhcpn->bhclp", Cc, prev) * torch.exp(a_cs)[..., None]
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, None]  # (b,1,c,i,j)
    below = torch.tril(torch.ones((L, L), dtype=torch.bool))
    seg = torch.where(below, a_cs[..., :, None] - a_cs[..., None, :], 0.0)
    w = rnd(torch.where(below, scores * torch.exp(seg), 0.0))  # (b,h,c,i,j)
    y = inter + torch.einsum("bhcij,bcjhp->bhcip", w, xc)
    y = y.permute(0, 2, 3, 1, 4).reshape(b, nc * L, h, p)[:, :s]
    return y.to(x.dtype), carry


def emulated_ssd_chunked(x, a, B_in, C_in, *, chunk=128, initial_state=None):
    """`ops.ssd_chunked` with the kernel emulation in the kernel's place:
    the wrapper's chunk rule, and the final state cast to x's dtype."""
    s = x.shape[1]
    chunk = min(chunk, max(8, 1 << (s - 1).bit_length()))
    y, fin = kernel_emulation(x, a, B_in, C_in, chunk=chunk, initial_state=initial_state)
    return y, fin.to(x.dtype)


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
    (twin, reason), = ssd_kernel.__torch_twins__.values()
    assert list(ssd_kernel.__torch_twins__) == ["ssd_scan"]
    assert twin is ssd_scan_ref and "chunk" in reason


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,with_state", EMULATION_CASES)
def test_kernel_emulation_matches_reference_kernel(shape, with_state, dtype):
    """The three phases with the bf16 kernel's rounding points stay within
    the reference's bar of its Pallas kernel (interpret mode)."""
    B, S, H, P, N, chunk = shape
    jin, tin = _both(_inputs(9, B, S, H, P, N, with_state), dtype)
    jkw = {"initial_state": jin.pop().astype(jnp.float32)} if with_state else {}
    tkw = {"initial_state": tin.pop().float()} if with_state else {}
    want_y, want_fin = ref_ssd_kernel(*jin, chunk=chunk, **jkw)
    got_y, got_fin = emulated_ssd_chunked(*tin, chunk=chunk, **tkw)
    assert got_y.shape == (B, S, H, P) and got_fin.shape == (B, H, P, N)
    assert got_y.dtype == got_fin.dtype == tin[0].dtype
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL[dtype])
    np.testing.assert_allclose(_np(got_fin), _np(want_fin), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,with_state", EMULATION_CASES)
def test_kernel_emulation_matches_reference_chunked_form(shape, with_state, dtype):
    """... and of the reference model's chunked einsum form
    (`repro.models.ssm.ssd_chunked`) at the chunk the wrapper picks. The
    chunked form is evaluated in f32 on the same inputs (bf16 values for
    bf16): run in bf16 it rounds every intermediate of its einsums and lies
    about 2 from the reference's own Pallas kernel at the first case, so
    it is the algorithm, not the type, that is held here."""
    B, S, H, P, N, chunk = shape
    chunk = min(chunk, max(8, 1 << (S - 1).bit_length()))
    jin, tin = _both(_inputs(10, B, S, H, P, N, with_state), dtype)
    jin = [v.astype(jnp.float32) for v in jin]
    jkw = {"initial_state": jin.pop()} if with_state else {}
    tkw = {"initial_state": tin.pop().float()} if with_state else {}
    want_y, want_fin = ref_ssm.ssd_chunked(*jin, chunk=chunk, **jkw)
    got_y, got_fin = emulated_ssd_chunked(*tin, chunk=chunk, **tkw)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL[dtype])
    np.testing.assert_allclose(_np(got_fin), _np(want_fin), **TOL[dtype])


def test_kernel_emulation_f32_matches_plain_version():
    """In f32 the phases reorder the scan's sums and round nowhere: the
    emulation agrees with the step-by-step recurrence at 2e-3, ragged
    tail and initial state included."""
    arrays = _inputs(11, 2, 150, 3, 32, 48, True)
    tx, ta, tb, tc, ts = (torch.from_numpy(v) for v in arrays)
    want_y, want_fin = ssd_scan_ref(tx, ta, tb, tc, ts)
    got_y, got_fin = kernel_emulation(tx, ta, tb, tc, chunk=64, initial_state=ts)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL["float32"])
    np.testing.assert_allclose(_np(got_fin), _np(want_fin), **TOL["float32"])


def _emulated_kernel(calls):
    def scan(x, a, B_in, C_in, *, chunk, initial_state=None, count=True):
        assert x.shape[-1] <= ssd_kernel.MAX_HEADDIM
        assert len({t.dtype for t in (x, a, B_in, C_in)}) == 1
        calls.append((x.shape[-1], x.dtype))
        ssd_kernel.launches += count
        return ssd_scan_ref(x, a, B_in, C_in, initial_state)
    return scan


def test_kernel_path_splits_wide_heads(monkeypatch):
    """P = 128 goes to the kernel as two blocks of 64 columns, the initial
    state split with them, and counts as one launch; the joined result is
    the plain version's, and the reference's Pallas kernel's (interpret
    mode)."""
    from repro_torch.kernels.ssd_scan import ops

    calls = []
    monkeypatch.setattr(ssd_kernel, "ssd_scan", _emulated_kernel(calls))
    monkeypatch.setattr(ssd_kernel, "launches", 0)
    arrays = _inputs(11, 1, 64, 2, 128, 32, with_state=True)
    (jx, ja, jb, jc, js), (tx, ta, tb, tc, ts) = _both(arrays)
    y, fin = ops.kernel_scan(tx, ta, tb, tc, chunk=32, initial_state=ts)
    assert calls == [(64, torch.float32), (64, torch.float32)]
    assert ssd_kernel.launches == 1
    want_y, want_fin = ref_ssd_kernel(jx, ja, jb, jc, chunk=32, initial_state=js)
    np.testing.assert_allclose(_np(y), _np(want_y), **TOL["float32"])
    np.testing.assert_allclose(_np(fin), _np(want_fin), **TOL["float32"])
    ry, rfin = ssd_scan_ref(tx, ta, tb, tc, ts)
    assert torch.equal(y, ry) and torch.equal(fin, rfin)


def test_kernel_path_widens_mixed_types(monkeypatch):
    """bfloat16 x with float32 a, B and C (the reference casts each input to
    fp32 on its own): the kernel gets one type, float32, each input widened
    exactly, and y comes back in x's type."""
    from repro_torch.kernels.ssd_scan import ops

    calls = []
    monkeypatch.setattr(ssd_kernel, "ssd_scan", _emulated_kernel(calls))
    tx, ta, tb, tc = (torch.from_numpy(a) for a in _inputs(12, 2, 40, 2, 16, 32))
    tx = tx.bfloat16()
    y, fin = ops.kernel_scan(tx, ta, tb, tc, chunk=64)
    assert calls == [(16, torch.float32)]
    want_y, want_fin = ssd_scan_ref(tx.float(), ta, tb, tc)
    assert torch.equal(y, want_y) and torch.equal(fin, want_fin)
    jx, ja, jb, jc = (jnp.asarray(np.asarray(t.float()), dt) for t, dt in
                      ((tx, jnp.bfloat16), (ta, jnp.float32), (tb, jnp.float32),
                       (tc, jnp.float32)))
    ref_y, _ = ref_ssd_kernel(jx, ja, jb, jc, chunk=64)
    np.testing.assert_allclose(_np(y.bfloat16()), _np(ref_y), **TOL["bfloat16"])
