"""The Mamba2 decode step's kernels (`kernels/ssm_step`, csrc/ssm_step.cu):
dispatch, the plain version, and the kernels' arithmetic.

On the CPU: `ops` sends CPU tensors (a DTensor cache on the CPU too) to the
plain version and every other tensor to the kernels, whose entry raises,
before any build or launch, for a DTensor, for dtypes and for widths it is
not built for (meta tensors stand in for CUDA ones); with `use_pallas` on the CPU the plain version gives
`mamba2_mixer_step` bit for bit the results of the code it replaced; a
plain-torch emulation of the kernels' rounding points stays within the SSD
scan's bar (2e-3 in float32, 2e-2 in bfloat16) of the plain version over 16
steps at the mamba2, granite and hymba smoke widths; the kernel entry
refuses CPU tensors and autograd; the twin registry names the plain
version; and a recorded decode step counts no kernel layer.

The tests marked `card` run on an NVIDIA card and skip without one
(`python -m pytest -m card tests/test_torch_ssm_step.py`): the kernels
against the plain version over 16 consecutive steps at mamba2-370m's
(B=8, H=32), granite-4.0-h-small's (B=1, H=128) and hymba-1.5b's (N=16)
decode widths, in float32 and bfloat16, the conv buffer and the state
updated in place; and a recorded decode step counts 48 kernel layers at
mamba2's depth, 36 at granite's layer pattern.
"""
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.ssm_step import mamba2_step, mamba2_step_ref
from repro_torch.kernels.ssm_step import kernel as step_kernel
from repro_torch.kernels.ssm_step import ops as step_ops
from repro_torch.models import decode_step, init_params, init_cache
from repro_torch.models import ssm
from repro_torch.models.common import rms_norm
from repro_torch.obs import spans

ARCHS = ["mamba2-370m", "granite-4.0-h-small", "hymba-1.5b"]
TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]
STEPS = 16
# the decode widths of the configurations that run the kernels: (batch, heads,
# head dim, state), mamba2-370m's cell, granite-4.0-h-small's at B=1, hymba-1.5b's
CARD_SHAPES = {"mamba2": (8, 32, 64, 128), "granite": (1, 128, 64, 128), "hymba": (2, 50, 64, 16)}
NAMES = ("xBC", "dt", "conv_buf", "state", "conv_w", "conv_b", "dt_bias", "A_log", "D")


def _layer0(params):
    return {k: v[0] for k, v in params["layers"].items() if k.startswith("ssm_")}


def _operands(b, nh, hd, N, dtype, seed, device="cpu", p=None):
    """One step's operands in `mamba2_step`'s order: the in-projection's
    x|B|C and dt rows, a conv buffer, an fp32 state, and the layer's conv
    and decay weights (`p`'s, else drawn)."""
    gen = torch.Generator().manual_seed(seed)
    width = nh * hd + 2 * N

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device=device, dtype=dtype)

    if p is None:
        p = {"ssm_conv_w": draw(4, width, scale=0.5), "ssm_conv_b": draw(width, scale=0.1),
             "ssm_dt_bias": draw(nh, scale=0.5),
             "ssm_A_log": torch.log(1 + 15 * torch.rand(nh, generator=gen)).to(device, dtype),
             "ssm_D": draw(nh)}
    state = (torch.randn((b, nh, hd, N), generator=gen) * 0.5).to(device)
    return [draw(b, width), draw(b, nh), draw(b, 3, width), state, p["ssm_conv_w"],
            p["ssm_conv_b"], p["ssm_dt_bias"], p["ssm_A_log"], p["ssm_D"]]


def kernel_emulation(xBC, dt, conv_buf, state, conv_w, conv_b, dt_bias, A_log, D):
    """The two kernels' arithmetic in plain torch (csrc/ssm_step.cu): the
    conv with f32 accumulation, rounded to the activation dtype after the
    window's product, the bias add and the SiLU; softplus (threshold 20),
    the decay and the state update in f32; y = C . state + D x in f32,
    rounded once. Returns (y, conv_buf', state', D x in f32)."""
    T = xBC.dtype

    def r(v):
        return v.to(T).float()

    b, nh, hd, N = state.shape
    di = nh * hd
    window = torch.cat([conv_buf, xBC[:, None, :]], dim=1)
    v = r(r((window.float() * conv_w.float()).sum(1)) + conv_b.float())
    conv = r(v / (1 + torch.exp(-v)))
    xs, B, C = conv[:, :di].reshape(b, nh, hd), conv[:, di:di + N], conv[:, di + N:]
    v = dt.float() + dt_bias.float()
    dt1 = torch.where(v > 20, v, torch.log1p(torch.exp(v)))
    dA = torch.exp(dt1 * -torch.exp(A_log.float()))
    state = state * dA[..., None, None] + (dt1[..., None] * xs)[..., None] * B[:, None, None, :]
    skip = D.float()[None, :, None] * xs
    y = (state * C[:, None, None, :]).sum(-1) + skip
    return y.to(T), window[:, 1:].clone(), state, skip


def _replaced_mixer_step(cfg, p, x, conv_buf, state):
    """`models/ssm.py::mamba2_mixer_step` as it was before the kernels."""
    b = x.shape[0]
    di, N, nh, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    zxbcdt = x @ p["ssm_in"]
    z, xBC, dt = ssm._split_proj(cfg, zxbcdt)
    xBC = xBC[:, 0]
    window = torch.cat([conv_buf.to(xBC.dtype), xBC[:, None, :]], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, p["ssm_conv_w"]) + p["ssm_conv_b"]
    conv = F.silu(conv)
    new_buf = window[:, 1:].to(conv_buf.dtype)
    xs = conv[:, :di].reshape(b, nh, hd)
    B = conv[:, di:di + N]
    C = conv[:, di + N:]
    dt1 = F.softplus(dt[:, 0].float() + p["ssm_dt_bias"].float())
    A = -torch.exp(p["ssm_A_log"].float())
    a_t = dt1 * A
    x_dt = xs * dt1.to(xs.dtype)[..., None]
    state, y = ssm.ssd_step(state, x_dt, a_t, B, C)
    y = y.to(x.dtype) + xs * p["ssm_D"].to(x.dtype)[None, :, None]
    y = y.reshape(b, 1, di)
    y = rms_norm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    return y @ p["ssm_out"], new_buf, state


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """The kernel entry and the plain version replaced by recorders."""
    calls = []

    def record(name):
        def fn(*args):
            calls.append(name)
            return args[0], args[2], args[3]
        return fn

    monkeypatch.setattr(step_ops.kernel, "mamba2_step", record("kernel"))
    monkeypatch.setattr(step_ops, "mamba2_step_ref", record("plain"))
    return calls


def test_cpu_tensors_take_the_plain_version(recorded):
    args = _operands(2, 4, 64, 32, torch.float32, seed=0)
    mamba2_step(*args)
    assert recorded == ["plain"]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 32, 64, 128), (1, 128, 64, 128), (2, 50, 64, 16),
                                   (1, 3, 48, 4)], ids=["mamba2", "granite", "hymba", "small"])
def test_card_tensors_in_the_limits_take_the_kernels(recorded, shape, dtype):
    args = _operands(*shape, dtype, seed=0, device="meta")
    mamba2_step(*args)
    assert recorded == ["kernel"]


def _out_of_limits(case):
    """Meta operands that the kernels do not take, one way each."""
    dtype = torch.bfloat16
    if case == "head_dim":
        return _operands(1, 2, 128, 128, dtype, seed=0, device="meta")
    if case == "state":
        return _operands(1, 2, 64, 256, dtype, seed=0, device="meta")
    if case == "state_not_a_power_of_two":
        return _operands(1, 2, 64, 48, dtype, seed=0, device="meta")
    args = _operands(1, 2, 64, 32, dtype, seed=0, device="meta")
    if case == "conv_width":
        args[2], args[4] = args[2][:, :2], args[4][:3]
    elif case == "float16":
        args = [a if i == 3 else a.to(torch.float16) for i, a in enumerate(args)]
    elif case == "mixed_dtypes":
        args[4] = args[4].float()
    elif case == "bf16_state":
        args[3] = args[3].to(dtype)
    return args


REFUSALS = {"head_dim": (ValueError, "head dim 128"), "state": (ValueError, "state 256"),
            "state_not_a_power_of_two": (ValueError, "state 48"),
            "conv_width": (ValueError, "conv width 3"),
            "float16": (TypeError, "float32 or bfloat16"),
            "mixed_dtypes": (TypeError, "of one dtype"),
            "bf16_state": (ValueError, "contiguous float32")}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_card_operands_out_of_the_limits_raise(case):
    """Off the CPU there is no fallback: the kernel entry refuses the
    operands before it builds or launches anything."""
    args = _out_of_limits(case)
    error, match = REFUSALS[case]
    before = step_kernel.launches
    with pytest.raises(error, match=match):
        mamba2_step(*args)
    assert step_kernel.launches == before


@pytest.fixture
def one_rank_mesh():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()


def _dtensor_leaf(args, mesh, leaf):
    i = NAMES.index(leaf)
    args[i] = DTensor.from_local(args[i], mesh, [Replicate()], run_check=False)
    return args


@pytest.mark.parametrize("leaf", ["conv_buf", "state"])
def test_a_dtensor_cache_on_the_cpu_takes_the_plain_version(recorded, one_rank_mesh, leaf):
    args = _dtensor_leaf(_operands(8, 32, 64, 128, torch.bfloat16, seed=0), one_rank_mesh, leaf)
    mamba2_step(*args)
    assert recorded == ["plain"]


@pytest.mark.parametrize("leaf", ["conv_buf", "state"])
def test_a_dtensor_cache_off_the_cpu_raises(one_rank_mesh, leaf):
    args = _operands(8, 32, 64, 128, torch.bfloat16, seed=0, device="meta")
    args = _dtensor_leaf(args, one_rank_mesh, leaf)
    before = step_kernel.launches
    with pytest.raises(TypeError, match="not DTensors"):
        mamba2_step(*args)
    assert step_kernel.launches == before


# ---------------------------------------------------------------------------
# the plain version and the kernels' arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_step_with_use_pallas_on_the_cpu_equals_the_replaced_code(arch, dtype):
    cfg = get_smoke_config(arch).with_(use_pallas=True, remat="none")
    params = init_params(cfg, torch.Generator().manual_seed(1), dtype, device="cpu")
    p = {k: v[0] for k, v in params["layers"].items()}
    gen = torch.Generator().manual_seed(2)
    b, width = 3, cfg.ssm_d_inner + 2 * cfg.ssm_state
    buf = torch.randn((b, cfg.ssm_conv - 1, width), generator=gen).to(dtype)
    state = torch.randn((b, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state), generator=gen)
    want_buf, want_state = buf.clone(), state.clone()
    with torch.no_grad():
        for _ in range(3):
            x = torch.randn((b, 1, cfg.d_model), generator=gen).to(dtype)
            got_y, buf, state = ssm.mamba2_mixer_step(cfg, p, x, buf, state)
            want_y, want_buf, want_state = _replaced_mixer_step(cfg, p, x, want_buf, want_state)
            for got, want in ((got_y, want_y), (buf, want_buf), (state, want_state)):
                assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_emulation_stays_within_the_bar_of_the_plain_version(arch, dtype):
    """16 steps, each side carrying its own buffer and state, at the smoke
    configuration's widths with its layer-0 weights."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(3), dtype, device="cpu")
    p = _layer0(params)
    b = 4
    plain = _operands(b, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, dtype, seed=4, p=p)
    emu = [t.clone() for t in plain]
    gen = torch.Generator().manual_seed(5)
    for _ in range(STEPS):
        x = torch.randn(plain[0].shape, generator=gen).to(dtype)
        dt = torch.randn(plain[1].shape, generator=gen).to(dtype)
        want_y, plain[2], plain[3] = mamba2_step_ref(x, dt, *plain[2:])
        got_y, emu[2], emu[3], _ = kernel_emulation(x, dt, *emu[2:])
        assert got_y.dtype == want_y.dtype == dtype
        torch.testing.assert_close(got_y.float(), want_y.float(), **TOL[dtype])
        assert torch.equal(emu[2], plain[2])  # the window moves, no arithmetic
        torch.testing.assert_close(emu[3], plain[3], **TOL[dtype])


def test_the_kernel_entry_refuses_cpu_tensors_and_autograd():
    args = _operands(2, 4, 64, 32, torch.float32, seed=0)
    before = step_kernel.launches
    with pytest.raises(ValueError, match="CUDA device"):
        step_kernel.mamba2_step(*args)
    args[4].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        step_kernel.mamba2_step(*args)
    assert step_kernel.launches == before


def test_the_twin_registry_names_the_plain_version():
    assert step_kernel.__torch_twins__ == {"mamba2_step": mamba2_step_ref}


@pytest.fixture
def recorder():
    rec = spans.attach()
    yield rec
    spans.detach()


def _recorded_step(recorder, cfg, device, batch=2):
    """One decode step from a fresh cache with spans on; the
    `model.decode_step` span's counters."""
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), torch.float32,
                         device=device)
    cache = init_cache(cfg, batch, 4, dtype=torch.float32, device=device)
    token = torch.zeros((batch, 1), dtype=torch.int64, device=device)
    with recorder.request(keep=True) as root:
        with torch.no_grad():
            decode_step(cfg, params, cache, token, 0)
    step, = [s for s in recorder.take(root.request) if s.name == "model.decode_step"]
    return step.counters


@pytest.mark.parametrize("arch", ["mamba2-370m", "granite-4.0-h-small", "qwen2-0.5b"])
def test_a_recorded_step_on_the_cpu_counts_no_kernel_layer(recorder, arch):
    cfg = get_smoke_config(arch).with_(use_pallas=True, remat="none")
    assert _recorded_step(recorder, cfg, "cpu") == {"ssm_kernel_layers": 0}


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _assert_y_close(got, want, skip, dtype):
    """y against the plain version's at the bar. In bfloat16 the plain
    version rounds y's two terms, C . state and D x, to bfloat16 before it
    adds them, so where they cancel its error is relative to the terms and
    not to y: the bar's relative part is taken on |y| + 2 |D x|, which
    bounds |C . state| + |D x|."""
    tol = TOL[dtype]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **tol)
        return
    err = (got.float() - want.float()).abs()
    bar = tol["atol"] + tol["rtol"] * (want.float().abs() + 2 * skip.abs())
    assert bool((err <= bar).all()), (err - bar).max().item()


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernels_equal_the_plain_version_over_steps_on_a_card(shape, dtype):
    dev = _card()
    b, nh, hd, N = CARD_SHAPES[shape]
    kern = _operands(b, nh, hd, N, dtype, seed=6, device=dev)
    plain = [t.clone() for t in kern]
    buf, state = kern[2], kern[3]
    ptrs = buf.data_ptr(), state.data_ptr()
    gen = torch.Generator(device=dev).manual_seed(7)
    before = step_kernel.launches
    with torch.no_grad():
        for _ in range(STEPS):
            x = torch.randn(kern[0].shape, generator=gen, device=dev).to(dtype)
            dt = torch.randn(kern[1].shape, generator=gen, device=dev).to(dtype)
            got_y, got_buf, got_state = mamba2_step(x, dt, *kern[2:])
            assert got_buf is buf and got_state is state  # in place
            skip = kernel_emulation(x, dt, *plain[2:])[3]
            want_y, plain[2], plain[3] = mamba2_step_ref(x, dt, *plain[2:])
            _assert_y_close(got_y, want_y, skip, dtype)
            assert torch.equal(buf, plain[2])
            torch.testing.assert_close(state, plain[3], **TOL[dtype])
    assert (buf.data_ptr(), state.data_ptr()) == ptrs
    assert step_kernel.launches - before == STEPS


@pytest.mark.card
@pytest.mark.parametrize("arch,layers", [("mamba2-370m", 48), ("granite-4.0-h-small", 36)])
def test_a_recorded_step_on_a_card_counts_every_mamba_layer(recorder, arch, layers):
    """The smoke widths at the published depth and layer pattern."""
    dev = _card()
    full = get_config(arch)
    cfg = get_smoke_config(arch).with_(use_pallas=True, remat="none", num_layers=full.num_layers,
                                       layer_types=full.layer_types)
    assert _recorded_step(recorder, cfg, dev) == {"ssm_kernel_layers": layers}
