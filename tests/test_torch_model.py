"""The port's dense decoder against the reference's, on the CPU.

Parameters come from the reference's `init_params` (smoke qwen2-0.5b) and
cross with `params_from_numpy`, so both packages compute the same function.
Tolerances: 2e-3 in float32, 2e-2 in bfloat16 (the reference's own bar,
tests/test_models.py and tests/test_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import attention as ref_attn
from repro_torch import models
from repro_torch.models import attention
from repro_torch.configs import get_smoke_config

ARCH = "qwen2-0.5b"
F32 = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=2e-2, atol=2e-2)
B, S = 2, 16


def _configs(**kw):
    return (ref_smoke_config(ARCH).with_(remat="none", **kw),
            get_smoke_config(ARCH).with_(remat="none", **kw))


def _params(jdtype=jnp.float32):
    ref_cfg, _ = _configs()
    ref_params = ref_models.init_params(ref_cfg, jax.random.PRNGKey(0), dtype=jdtype)
    port_params = models.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_params, port_params


def _tokens(seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def f32_params():
    return _params()


def test_params_cross_leaf_for_leaf(f32_params):
    ref_params, port_params = f32_params
    _, cfg = _configs()
    shapes = models.param_shapes(cfg)
    assert sorted(port_params) == sorted(shapes) == sorted(ref_params)
    for name, shape in shapes["layers"].items():
        assert tuple(port_params["layers"][name].shape) == shape
        np.testing.assert_array_equal(
            port_params["layers"][name].numpy(), np.asarray(ref_params["layers"][name]))


def test_forward_matches_reference(f32_params):
    ref_params, port_params = f32_params
    ref_cfg, cfg = _configs()
    tokens = _tokens(1, cfg.vocab_size)
    want, _ = ref_models.forward(ref_cfg, ref_params, jnp.asarray(tokens))
    got, aux = models.forward(cfg, port_params, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert float(aux["lb_loss"]) == 0.0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_forward_matches_reference(f32_params, use_pallas):
    ref_params, port_params = f32_params
    ref_cfg, cfg = _configs(use_pallas=use_pallas)
    tokens = _tokens(2, cfg.vocab_size)
    want_logits, want_cache = ref_models.prefill_forward(ref_cfg, ref_params, jnp.asarray(tokens))
    got_logits, got_cache = models.prefill_forward(cfg, port_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **F32)
    assert sorted(got_cache) == sorted(want_cache) == ["k", "v"]
    for key in ("k", "v"):
        assert tuple(got_cache[key].shape) == want_cache[key].shape
        np.testing.assert_allclose(_np(got_cache[key]), _np(want_cache[key]), **F32)


def test_prefill_and_decode_step_match_reference(f32_params):
    ref_params, port_params = f32_params
    ref_cfg, cfg = _configs()
    tokens = _tokens(3, cfg.vocab_size)
    max_len = S + 4
    want_logits, want_cache = ref_models.prefill(ref_cfg, ref_params, jnp.asarray(tokens), max_len)
    got_logits, got_cache = models.prefill(cfg, port_params, torch.from_numpy(tokens), max_len)
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(got_cache[key]), _np(want_cache[key]), **F32)

    tok = np.argmax(np.asarray(want_logits), axis=-1)[:, None].astype(np.int32)
    want_step, want_next = ref_models.decode_step(
        ref_cfg, ref_params, want_cache, jnp.asarray(tok), jnp.int32(S))
    got_step, got_next = models.decode_step(cfg, port_params, got_cache, torch.from_numpy(tok), S)
    np.testing.assert_allclose(_np(got_step), _np(want_step), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(got_next[key]), _np(want_next[key]), **F32)


def test_prefill_forward_bf16_matches_reference():
    ref_params, port_params = _params(jnp.bfloat16)
    assert port_params["embed"].dtype == torch.bfloat16
    ref_cfg, cfg = _configs(use_pallas=True)
    tokens = _tokens(4, cfg.vocab_size)
    want_logits, want_cache = ref_models.prefill_forward(ref_cfg, ref_params, jnp.asarray(tokens))
    got_logits, got_cache = models.prefill_forward(cfg, port_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **BF16)
    for key in ("k", "v"):
        assert got_cache[key].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got_cache[key]), _np(want_cache[key]), **BF16)


def test_sliding_window_ring_cache_matches_reference(f32_params):
    """A window shorter than the prompt: the prefill cache comes back in
    ring order and decoding continues from it as the reference does."""
    ref_params, port_params = f32_params
    ref_cfg, cfg = _configs(sliding_window=8)
    tokens = _tokens(5, cfg.vocab_size)
    want_logits, want_cache = ref_models.prefill_forward(ref_cfg, ref_params, jnp.asarray(tokens))
    got_logits, got_cache = models.prefill_forward(cfg, port_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **F32)
    tok = np.argmax(np.asarray(want_logits), axis=-1)[:, None].astype(np.int32)
    want_step, _ = ref_models.decode_step(
        ref_cfg, ref_params, want_cache, jnp.asarray(tok), jnp.int32(S))
    got_step, _ = models.decode_step(cfg, port_params, got_cache, torch.from_numpy(tok), S)
    np.testing.assert_allclose(_np(got_step), _np(want_step), **F32)


def test_decoder_module_wraps_the_functional_forward(f32_params):
    _, port_params = f32_params
    _, cfg = _configs()
    lm = models.DecoderLM(cfg, port_params)
    tokens = torch.from_numpy(_tokens(6, cfg.vocab_size))
    want, _ = models.forward(cfg, port_params, tokens)
    assert torch.equal(lm(tokens), want)
    assert sorted(lm.tree()["layers"]) == sorted(port_params["layers"])


def test_init_params_is_seeded_and_shaped():
    _, cfg = _configs()
    gens = [torch.Generator(device="cpu").manual_seed(7) for _ in range(2)]
    a, b = (models.init_params(cfg, g, dtype=torch.float32, device="cpu") for g in gens)
    for name, shape in models.param_shapes(cfg)["layers"].items():
        assert tuple(a["layers"][name].shape) == shape
        assert a["layers"][name].device.type == "cpu"
        assert torch.equal(a["layers"][name], b["layers"][name])
    assert torch.all(a["layers"]["ln1"] == 1) and torch.all(a["layers"]["bq"] == 0)


def test_init_params_defaults_to_cuda_and_never_follows_the_generator():
    """Without device="cpu" the parameters go to CUDA: a CPU generator does
    not quietly move them onto the CPU."""
    _, cfg = _configs()
    gen = torch.Generator(device="cpu").manual_seed(7)
    with pytest.raises((RuntimeError, ValueError), match="CUDA is not available|generator on cpu"):
        models.init_params(cfg, gen, dtype=torch.float32)


@pytest.mark.parametrize("arch", ["dbrx-132b", "seamless-m4t-medium"])
def test_unported_families_raise(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        models.param_shapes(cfg)


def _qkv(seed, B_, S_, H, K, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B_, S_, H, D), (B_, S_, K, D), (B_, S_, K, D))]


@pytest.mark.parametrize("window", [0, 24])
def test_attend_chunked_matches_reference(window):
    """The q-chunked path (prefill beyond 2048 tokens) at a small chunk."""
    q, k, v = _qkv(7, 2, 64, 4, 2, 16)
    want = ref_attn.attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=True, window=window, chunk=16)
    got = attention.attend_chunked(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True, window=window, chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_cache_update_ring_buffer_matches_reference():
    """Ring-buffer writes past the window wrap and mark every slot live."""
    rng = np.random.default_rng(8)
    W = 4
    ref_k = ref_v = jnp.zeros((1, W, 2, 8), jnp.float32)
    k_cache, v_cache = torch.zeros((1, W, 2, 8)), torch.zeros((1, W, 2, 8))
    for pos in range(7):
        kn = rng.standard_normal((1, 1, 2, 8), dtype=np.float32)
        vn = rng.standard_normal((1, 1, 2, 8), dtype=np.float32)
        ref_k, ref_v, ref_valid = ref_attn.cache_update(
            ref_k, ref_v, jnp.asarray(kn), jnp.asarray(vn), jnp.int32(pos), window=W)
        k_cache, v_cache, valid = attention.cache_update(
            k_cache, v_cache, torch.from_numpy(kn), torch.from_numpy(vn), pos, window=W)
        np.testing.assert_array_equal(k_cache.numpy(), np.asarray(ref_k))
        np.testing.assert_array_equal(v_cache.numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
        q = rng.standard_normal((1, 1, 4, 8), dtype=np.float32)
        want = ref_attn.attend_cached(jnp.asarray(q), ref_k, ref_v, ref_valid)
        got = attention.attend_cached(torch.from_numpy(q), k_cache, v_cache, valid)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
