"""The port's ssm (mamba2) and hybrid (hymba) families against the
reference's, on the CPU.

Parameters come from the reference's `init_params` on its smoke configs
and cross with `params_from_numpy`, so both packages compute the same
function. With `use_pallas` set, the reference runs its Pallas kernels in
interpret mode and the port its wrappers' plain versions. Tolerances: 2e-3
in float32, 2e-2 in bfloat16 (the reference's own bar).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import ssm as ref_ssm
from repro_torch import models
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm

ARCHS = ["mamba2-370m", "hymba-1.5b"]
F32 = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=2e-2, atol=2e-2)
B, S = 2, 16
SSM_LEAVES = ("conv_buf", "ssm_state")


def _configs(arch, **kw):
    return (ref_smoke_config(arch).with_(remat="none", **kw),
            get_smoke_config(arch).with_(remat="none", **kw))


def _params(arch, jdtype=jnp.float32, **kw):
    ref_cfg, _ = _configs(arch, **kw)
    ref_params = ref_models.init_params(ref_cfg, jax.random.PRNGKey(0), dtype=jdtype)
    port_params = models.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_params, port_params


def _tokens(seed, vocab, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, s), dtype=np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cache_leaves(cfg):
    return sorted(SSM_LEAVES + (() if cfg.arch_type == "ssm" else ("k", "v")))


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    return (request.param,) + _params(request.param)


def test_params_cross_leaf_for_leaf(f32):
    arch, ref_params, port_params = f32
    _, cfg = _configs(arch)
    shapes = models.param_shapes(cfg)
    assert sorted(port_params) == sorted(shapes) == sorted(ref_params)
    assert sorted(shapes["layers"]) == sorted(ref_params["layers"])
    for name, shape in shapes["layers"].items():
        assert tuple(port_params["layers"][name].shape) == shape
        np.testing.assert_array_equal(
            port_params["layers"][name].numpy(), np.asarray(ref_params["layers"][name]))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_reference(f32, use_pallas):
    arch, ref_params, port_params = f32
    ref_cfg, cfg = _configs(arch, use_pallas=use_pallas)
    tokens = _tokens(1, cfg.vocab_size)
    want, _ = ref_models.forward(ref_cfg, ref_params, jnp.asarray(tokens))
    got, _ = models.forward(cfg, port_params, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_forward_and_decode_match_reference(f32, use_pallas):
    """Logits and every cache leaf of the parallel prefill, then one decode
    step from that cache."""
    arch, ref_params, port_params = f32
    ref_cfg, cfg = _configs(arch, use_pallas=use_pallas)
    tokens = _tokens(2, cfg.vocab_size)
    want_logits, want_cache = ref_models.prefill_forward(ref_cfg, ref_params, jnp.asarray(tokens))
    got_logits, got_cache = models.prefill_forward(cfg, port_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **F32)
    assert sorted(got_cache) == sorted(want_cache) == _cache_leaves(cfg)
    for key in want_cache:
        assert tuple(got_cache[key].shape) == want_cache[key].shape
        assert str(got_cache[key].dtype).removeprefix("torch.") == want_cache[key].dtype.name
        np.testing.assert_allclose(_np(got_cache[key]), _np(want_cache[key]), **F32)

    tok = np.argmax(np.asarray(want_logits), axis=-1)[:, None].astype(np.int32)
    want_step, want_next = ref_models.decode_step(
        ref_cfg, ref_params, want_cache, jnp.asarray(tok), jnp.int32(S))
    got_step, got_next = models.decode_step(cfg, port_params, got_cache, torch.from_numpy(tok), S)
    np.testing.assert_allclose(_np(got_step), _np(want_step), **F32)
    for key in want_next:
        np.testing.assert_allclose(_np(got_next[key]), _np(want_next[key]), **F32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_step_match_reference(f32, use_pallas):
    """The replay prefill (token by token through decode_step, which no
    kernel serves), then one more decode step from its cache."""
    arch, ref_params, port_params = f32
    ref_cfg, cfg = _configs(arch, use_pallas=use_pallas)
    tokens = _tokens(3, cfg.vocab_size)
    max_len = S + 4
    want_logits, want_cache = ref_models.prefill(ref_cfg, ref_params, jnp.asarray(tokens), max_len)
    got_logits, got_cache = models.prefill(cfg, port_params, torch.from_numpy(tokens), max_len)
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **F32)
    assert sorted(got_cache) == sorted(want_cache) == _cache_leaves(cfg)
    for key in want_cache:
        assert tuple(got_cache[key].shape) == want_cache[key].shape
        np.testing.assert_allclose(_np(got_cache[key]), _np(want_cache[key]), **F32)

    tok = np.argmax(np.asarray(want_logits), axis=-1)[:, None].astype(np.int32)
    want_step, want_next = ref_models.decode_step(
        ref_cfg, ref_params, want_cache, jnp.asarray(tok), jnp.int32(S))
    got_step, got_next = models.decode_step(cfg, port_params, got_cache, torch.from_numpy(tok), S)
    np.testing.assert_allclose(_np(got_step), _np(want_step), **F32)
    for key in want_next:
        np.testing.assert_allclose(_np(got_next[key]), _np(want_next[key]), **F32)


def _layer0(tree):
    return {k: v[0] for k, v in tree["layers"].items()}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mixer_and_mixer_step_match_reference(f32, use_pallas):
    arch, ref_params, port_params = f32
    ref_cfg, cfg = _configs(arch, use_pallas=use_pallas)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    s0 = rng.standard_normal((B, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
                             dtype=np.float32) * 0.5
    jp, tp = _layer0(ref_params), _layer0(port_params)
    want = ref_ssm.mamba2_mixer(ref_cfg, jp, jnp.asarray(h), initial_state=jnp.asarray(s0))
    got = ssm.mamba2_mixer(cfg, tp, torch.from_numpy(h), initial_state=torch.from_numpy(s0))
    for g, w in zip(got, want):  # y, final state, conv tail
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **F32)

    x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
    want_y, want_buf, want_st = ref_ssm.mamba2_mixer_step(
        ref_cfg, jp, jnp.asarray(x1), want[2], want[1].astype(jnp.float32))
    got_y, got_buf, got_st = ssm.mamba2_mixer_step(cfg, tp, torch.from_numpy(x1), got[2],
                                                   got[1].float())
    for g, w in ((got_y, want_y), (got_buf, want_buf), (got_st, want_st)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **F32)


def test_prefill_forward_bf16_matches_reference():
    """bf16 weights through the kernel path (mamba2): the shipped state is
    rounded to bf16 by the wrapper and cast back to fp32, as in the
    reference. One layer: the two packages round bf16 intermediates in
    different places (about 70 % of a layer's mixer outputs differ by one
    bf16 ulp), and a second layer amplifies that noise past the 2e-2 bar in
    one element of its conv buffer. Hybrid is held in f32 only: after one
    bf16 layer each package's logits are 0.034 from an f32 evaluation of
    the same bf16 weights, so no port could meet 2e-2 against the
    reference's own bf16 rounding."""
    ref_cfg, cfg = _configs("mamba2-370m", use_pallas=True, num_layers=1)
    ref_params, port_params = _params("mamba2-370m", jnp.bfloat16, num_layers=1)
    tokens = _tokens(5, cfg.vocab_size)
    want_logits, want_cache = ref_models.prefill_forward(ref_cfg, ref_params, jnp.asarray(tokens))
    got_logits, got_cache = models.prefill_forward(cfg, port_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **BF16)
    assert got_cache["ssm_state"].dtype == torch.float32
    assert got_cache["conv_buf"].dtype == torch.bfloat16
    assert sorted(got_cache) == sorted(want_cache)
    for key in want_cache:
        np.testing.assert_allclose(_np(got_cache[key]), _np(want_cache[key]), **BF16)


def test_hymba_ring_cache_wraps_like_the_reference():
    """A prompt longer than the window: the hybrid prefill ships a
    window-wide ring and decoding continues from it as the reference does."""
    ref_params, port_params = _params("hymba-1.5b")
    ref_cfg, cfg = _configs("hymba-1.5b", sliding_window=8, use_pallas=True)
    tokens = _tokens(6, cfg.vocab_size, s=20)
    want_logits, want_cache = ref_models.prefill_forward(ref_cfg, ref_params, jnp.asarray(tokens))
    got_logits, got_cache = models.prefill_forward(cfg, port_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **F32)
    assert got_cache["k"].shape[2] == 8
    for key in want_cache:
        np.testing.assert_allclose(_np(got_cache[key]), _np(want_cache[key]), **F32)
    tok = np.argmax(np.asarray(want_logits), axis=-1)[:, None].astype(np.int32)
    want_step, _ = ref_models.decode_step(
        ref_cfg, ref_params, want_cache, jnp.asarray(tok), jnp.int32(20))
    got_step, _ = models.decode_step(cfg, port_params, got_cache, torch.from_numpy(tok), 20)
    np.testing.assert_allclose(_np(got_step), _np(want_step), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_special_values(arch):
    _, cfg = _configs(arch)
    gens = [torch.Generator(device="cpu").manual_seed(7) for _ in range(2)]
    a, b = (models.init_params(cfg, g, dtype=torch.float32, device="cpu") for g in gens)
    for name, shape in models.param_shapes(cfg)["layers"].items():
        assert tuple(a["layers"][name].shape) == shape
        assert torch.equal(a["layers"][name], b["layers"][name])
    lp, L, nh = a["layers"], cfg.num_layers, cfg.ssm_nheads
    want_a_log = np.tile(np.log(np.arange(1, nh + 1, dtype=np.float32))[None], (L, 1))
    np.testing.assert_allclose(lp["ssm_A_log"].numpy(), want_a_log, rtol=1e-6)
    assert torch.all(lp["ssm_D"] == 1) and torch.all(lp["ssm_norm"] == 1)
    assert torch.all(lp["ssm_dt_bias"] == -2) and torch.all(lp["ssm_conv_b"] == 0)
    assert torch.all(lp["ln1"] == 1)
    std = lp["ssm_conv_w"].std().item()
    assert 0.07 < std < 0.13  # Normal(0, 0.1**2)
    ref_cfg, _ = _configs(arch)
    ref_shapes = ref_models.param_shapes(ref_cfg)
    assert models.param_shapes(cfg)["layers"] == ref_shapes["layers"]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference_layout(arch):
    ref_cfg, cfg = _configs(arch)
    want = ref_models.init_cache(ref_cfg, B, 24, dtype=jnp.bfloat16)
    got = models.init_cache(cfg, B, 24, dtype=torch.bfloat16, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).removeprefix("torch.") == want[key].dtype.name
        assert not torch.any(got[key].float() != 0)


def _load(path):
    spec = importlib.util.spec_from_file_location(f"{path.stem}_for_ssm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mamba2_bf16_serving_gate_rehearsed_with_the_emulation(monkeypatch):
    """chip_smoke.py's mamba2-370m serve_bf16 gate at smoke size on the CPU:
    the kernel prefill (here the emulation of the three-phase bf16 kernel,
    one call per Mamba2 layer) lies no further from an f32 evaluation of
    the same bf16 weights than BF16_GATE times the plain bf16 prefill
    does, and both distances are finite and nonzero."""
    from repro_torch.kernels.ssd_scan import ops

    here = Path(__file__).resolve().parent
    emu = _load(here / "test_torch_ssd_scan.py")
    cs = _load(here.parent / "chip_smoke.py")
    calls = []

    def kernel(x, a, B_in, C_in, *, chunk=128, initial_state=None):
        calls.append(x.dtype)
        return emu.emulated_ssd_chunked(x, a, B_in, C_in, chunk=chunk,
                                        initial_state=initial_state)

    monkeypatch.setattr(ops, "ssd_chunked", kernel)
    cfg = get_smoke_config("mamba2-370m").with_(use_pallas=True, remat="none")
    params = models.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                                device="cpu")
    prompts = torch.from_numpy(_tokens(0, cfg.vocab_size, s=64))
    logits, cache = models.prefill_forward(cfg, params, prompts)
    assert calls == [torch.bfloat16] * cfg.num_layers
    assert cache["ssm_state"].dtype == torch.float32
    kernel_dist, plain_dist = cs.prefill_distances(cfg, params, prompts, logits)
    assert len(calls) == cfg.num_layers  # the yardstick and the plain prefill skip the kernel
    assert np.isfinite(kernel_dist) and np.isfinite(plain_dist) and plain_dist > 0
    assert kernel_dist <= cs.BF16_GATE * plain_dist, (kernel_dist, plain_dist)
