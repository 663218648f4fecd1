"""The MoE and enc-dec families in the port against the reference, on the CPU.

qwen3-moe-235b-a22b and dbrx-132b (top-k experts, sorted dispatch) and
seamless-m4t-medium (bidirectional encoder, decoder with cross-attention),
at their smoke sizes. Parameters come from the reference's `init_params`
and cross with `params_from_numpy`, so both packages compute the same
function; enc-dec frames come from a seeded numpy generator. Tolerances:
2e-3 in float32, 2e-2 in bfloat16 (the reference's bar,
tests/test_models.py and tests/test_kernels.py). Every config of the
port also runs every entry point.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import FabricSpec as RefFabricSpec
from repro.core import TentEngine as RefTentEngine
from repro.serving import disagg as ref_disagg
from repro_torch import models
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import FabricSpec, TentEngine
from repro_torch.serving import DisaggregatedServer, monolithic_generate

FAMILIES = ["qwen3-moe-235b-a22b", "dbrx-132b", "seamless-m4t-medium"]
F32 = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=2e-2, atol=2e-2)
B, S, S_ENC = 2, 16, 8


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="float32"):
    """Both packages' configs and parameters, a prompt, and enc-dec frames
    (None for the decoder-only families), per arch and parameter type."""
    ref_cfg = ref_smoke_config(arch).with_(remat="none")
    cfg = get_smoke_config(arch).with_(remat="none")
    ref_params = ref_models.init_params(ref_cfg, jax.random.PRNGKey(0),
                                        dtype=getattr(jnp, dtype))
    params = models.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                                      device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    frames = None
    if cfg.is_encdec:
        frames = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    return ref_cfg, ref_params, cfg, params, tokens, frames


def _enc(frames, params=None):
    """enc_frames keyword arguments for (reference, port), in the
    parameters' type."""
    if frames is None:
        return {}, {}
    dt = params["embed"].dtype if params is not None else torch.float32
    return ({"enc_frames": jnp.asarray(frames).astype(jnp.float32 if dt == torch.float32
                                                      else jnp.bfloat16)},
            {"enc_frames": torch.from_numpy(frames).to(dt)})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_cross_leaf_for_leaf(arch):
    """`params_from_numpy` maps the reference's tree (router, expert
    leaves, cross-attention leaves, the encoder's subtree) onto the
    port's `param_shapes` unchanged."""
    _, ref_params, cfg, params, _, _ = _setup(arch)
    want = dict(_leaves(ref_params))
    got = dict(_leaves(params))
    shapes = dict(_leaves(models.param_shapes(cfg)))
    assert sorted(got) == sorted(want) == sorted(shapes)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == shapes[name]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_match_reference_at_full_width(arch):
    """Every config of the port, at its published widths, has the
    reference's parameter tree (shapes only: nothing is allocated)."""
    got = dict(_leaves(models.param_shapes(get_config(arch))))
    want = dict(_leaves(ref_models.param_shapes(ref_config(arch))))
    assert got == want


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch):
    ref_cfg, ref_params, cfg, params, tokens, frames = _setup(arch)
    kw_ref, kw = _enc(frames)
    want, want_aux = ref_models.forward(ref_cfg, ref_params, jnp.asarray(tokens), **kw_ref)
    got, aux = models.forward(cfg, params, torch.from_numpy(tokens), **kw)
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]), **F32)
    if cfg.num_experts:
        assert float(aux["lb_loss"]) > 0 and float(aux["z_loss"]) > 0


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_forward_matches_reference(arch, use_pallas):
    """Last-token logits and every cache leaf, enc_k/enc_v included."""
    ref_cfg, ref_params, cfg, params, tokens, frames = _setup(arch)
    ref_cfg, cfg = ref_cfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    kw_ref, kw = _enc(frames)
    want_logits, want_cache = ref_models.prefill_forward(ref_cfg, ref_params,
                                                         jnp.asarray(tokens), **kw_ref)
    got_logits, got_cache = models.prefill_forward(cfg, params, torch.from_numpy(tokens), **kw)
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **F32)
    assert sorted(got_cache) == sorted(want_cache)
    assert ("enc_k" in got_cache) == cfg.is_encdec
    for key in want_cache:
        assert tuple(got_cache[key].shape) == want_cache[key].shape
        np.testing.assert_allclose(_np(got_cache[key]), _np(want_cache[key]), **F32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_step_match_reference(arch):
    """The replay prefill (MoE routed at T = B every step) and one decode
    step from its cache."""
    ref_cfg, ref_params, cfg, params, tokens, frames = _setup(arch)
    kw_ref, kw = _enc(frames)
    max_len = S + 4
    want_logits, want_cache = ref_models.prefill(ref_cfg, ref_params, jnp.asarray(tokens),
                                                 max_len, **kw_ref)
    got_logits, got_cache = models.prefill(cfg, params, torch.from_numpy(tokens), max_len, **kw)
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **F32)
    assert sorted(got_cache) == sorted(want_cache)
    for key in want_cache:
        np.testing.assert_allclose(_np(got_cache[key]), _np(want_cache[key]), **F32)

    tok = np.argmax(np.asarray(want_logits), axis=-1)[:, None].astype(np.int32)
    want_step, want_next = ref_models.decode_step(
        ref_cfg, ref_params, want_cache, jnp.asarray(tok), jnp.int32(S))
    got_step, got_next = models.decode_step(cfg, params, got_cache, torch.from_numpy(tok), S)
    np.testing.assert_allclose(_np(got_step), _np(want_step), **F32)
    for key in want_next:
        np.testing.assert_allclose(_np(got_next[key]), _np(want_next[key]), **F32)


def _first_layers(params):
    """The parameters with every stacked "layers" leaf (the encoder's too)
    cut to its first layer."""
    out = {}
    for name, sub in params.items():
        if name == "layers":
            out[name] = {k: v[:1] for k, v in sub.items()}
        elif isinstance(sub, dict):
            out[name] = _first_layers(sub)
        else:
            out[name] = sub
    return out


def _bf16_setup(arch, one_layer=False):
    """The bf16 smoke parameters, with `one_layer` cut to one decoder (and
    encoder) layer by slicing the stacked leaves: the same weights in both
    packages."""
    ref_cfg, ref_params, cfg, params, tokens, frames = _setup(arch, "bfloat16")
    if one_layer:
        cut = {"num_layers": 1, "encoder_layers": 1 if cfg.is_encdec else 0}
        ref_params, params = _first_layers(ref_params), _first_layers(params)
        ref_cfg, cfg = ref_cfg.with_(**cut), cfg.with_(**cut)
    ref_cfg, cfg = ref_cfg.with_(use_pallas=True), cfg.with_(use_pallas=True)
    return ref_cfg, ref_params, cfg, params, tokens, frames


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_forward_bf16_matches_reference(arch):
    """bf16 at 2e-2 on one layer (the two packages round bf16
    intermediates in different places, and after two layers the logits
    of every family, dense deepseek-7b's too, stray past 2e-2; the next
    test holds the full smoke depth). seamless: one encoder and one
    decoder layer; its last-token logits are held by the next test."""
    ref_cfg, ref_params, cfg, params, tokens, frames = _bf16_setup(arch, one_layer=True)
    assert params["embed"].dtype == torch.bfloat16
    kw_ref, kw = _enc(frames, params)
    want_logits, want_cache = ref_models.prefill_forward(ref_cfg, ref_params,
                                                         jnp.asarray(tokens), **kw_ref)
    got_logits, got_cache = models.prefill_forward(cfg, params, torch.from_numpy(tokens), **kw)
    if not cfg.is_encdec:
        np.testing.assert_allclose(_np(got_logits), _np(want_logits), **BF16)
    assert sorted(got_cache) == sorted(want_cache)
    for key in want_cache:
        assert got_cache[key].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got_cache[key]), _np(want_cache[key]), **BF16)


BF16_GATE = 1.5  # chip_smoke.py's bar for a bf16 prefill against an f32 evaluation


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_forward_bf16_as_close_to_f32_as_reference(arch):
    """At the full smoke depth: the port's bf16 last-token logits lie no
    further from an f32 evaluation of the same bf16 weights (the
    yardstick) than 1.5x the reference's bf16 logits do."""
    ref_cfg, ref_params, cfg, params, tokens, frames = _bf16_setup(arch)
    kw_ref, kw = _enc(frames, params)
    want, _ = ref_models.prefill_forward(ref_cfg, ref_params, jnp.asarray(tokens), **kw_ref)
    got, _ = models.prefill_forward(cfg, params, torch.from_numpy(tokens), **kw)
    f32 = jax.tree_util.tree_map(lambda t: t.float(), params)
    kw32 = {n: t.float() for n, t in kw.items()}
    yard, _ = models.prefill_forward(cfg.with_(use_pallas=False), f32,
                                     torch.from_numpy(tokens), **kw32)
    ref_dist = np.abs(_np(want) - _np(yard)).max()
    port_dist = np.abs(_np(got) - _np(yard)).max()
    assert 0 < port_dist <= BF16_GATE * ref_dist, (port_dist, ref_dist)


def test_encode_bf16_matches_reference():
    ref_cfg, ref_params, cfg, params, _, frames = _bf16_setup("seamless-m4t-medium")
    kw_ref, kw = _enc(frames, params)
    want = ref_models.model.encode(ref_cfg, ref_params, kw_ref["enc_frames"])
    got = models.encode(cfg, params, kw["enc_frames"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_encode_matches_reference():
    ref_cfg, ref_params, cfg, params, _, frames = _setup("seamless-m4t-medium")
    want = ref_models.model.encode(ref_cfg, ref_params, jnp.asarray(frames))
    got = models.encode(cfg, params, torch.from_numpy(frames))
    assert got.shape == (B, S_ENC, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_decoder_module_holds_the_encoder():
    """`DecoderLM` keeps the encoder's subtree and hands the functional
    forward the same tree."""
    _, _, cfg, params, tokens, frames = _setup("seamless-m4t-medium")
    lm = models.DecoderLM(cfg, params)
    assert dict(_leaves(lm.tree())).keys() == dict(_leaves(params)).keys()
    want, _ = models.forward(cfg, params, torch.from_numpy(tokens),
                             enc_frames=torch.from_numpy(frames))
    assert torch.equal(lm(torch.from_numpy(tokens), torch.from_numpy(frames)), want)


def test_encdec_entry_points_need_frames():
    _, _, cfg, params, tokens, _ = _setup("seamless-m4t-medium")
    for call in (lambda: models.forward(cfg, params, torch.from_numpy(tokens)),
                 lambda: models.prefill_forward(cfg, params, torch.from_numpy(tokens)),
                 lambda: models.prefill(cfg, params, torch.from_numpy(tokens), S + 2)):
        with pytest.raises(ValueError, match="enc_frames"):
            call()


N_NEW, MAX_LEN = 6, 32


@pytest.mark.parametrize("arch", FAMILIES)
def test_disagg_generate_matches_monolithic_and_reference(arch):
    """The disaggregated server (replay prefill, the cache through TENT,
    decode) equals monolithic generation in the port, and both give the
    reference's tokens; seamless ships its cross-attention K/V in the
    cache."""
    ref_cfg, ref_params, cfg, params, tokens, frames = _setup(arch)
    prompt = tokens[:1, :12]
    frames = None if frames is None else frames[:1]
    kw_ref, kw = _enc(frames)
    ref_server = ref_disagg.DisaggregatedServer(RefTentEngine(RefFabricSpec()), ref_cfg,
                                                ref_params)
    want = ref_server.generate(jnp.asarray(prompt), N_NEW, MAX_LEN, **kw_ref)
    server = DisaggregatedServer(TentEngine(FabricSpec()), cfg, params)
    got = server.generate(torch.from_numpy(prompt), N_NEW, MAX_LEN, **kw)
    mono = monolithic_generate(cfg, params, torch.from_numpy(prompt), N_NEW, MAX_LEN, **kw)
    np.testing.assert_array_equal(got.tokens, mono)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.kv_bytes == want.kv_bytes
    assert got.kv_transfer_seconds == want.kv_transfer_seconds


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_runs_every_entry_point(arch):
    """No family is refused: each smoke config's parameters from the port's
    own `init_params` go through forward, prefill_forward, init_cache,
    decode_step and prefill, with finite logits of the expected shapes."""
    cfg = get_smoke_config(arch).with_(remat="none")
    params = models.init_params(cfg, torch.Generator(device="cpu").manual_seed(3),
                                dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 6), dtype=np.int32))
    kw = {}
    if cfg.is_encdec:
        kw["enc_frames"] = torch.from_numpy(
            rng.standard_normal((1, 4, cfg.d_model)).astype(np.float32))
    logits, _ = models.forward(cfg, params, tokens, **kw)
    last, pf_cache = models.prefill_forward(cfg, params, tokens, **kw)
    cache = models.init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu",
                              enc_len=4 if cfg.is_encdec else 0)
    assert sorted(cache) == sorted(pf_cache)
    step, _ = models.decode_step(cfg, params, cache, tokens[:, :1], 0)
    replay, _ = models.prefill(cfg, params, tokens, 8, **kw)
    assert logits.shape == (1, 6, cfg.vocab_size)
    for out in (logits, last, step, replay):
        assert bool(torch.isfinite(out).all())
    if cfg.num_experts == 0:
        # the replay equals the parallel pass (MoE routes T = 1 token a step
        # in the replay, with another capacity, so it may drop other pairs)
        torch.testing.assert_close(replay, logits[:, -1], **F32)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_route_flip_analysis():
    """`chip_smoke.py`'s MoE plain-prefill check at smoke size on the CPU:
    the recorder sees one `route` call a layer and leaves `route` as it
    was; two equal prefills differ nowhere; a pick changed by hand in
    layer 0 is reported as a first difference in its row, with the
    tokens whose kept pairs it moves, and `_kept` drops what
    `moe_ffn_sorted` drops."""
    cs = _chip_smoke()
    _, _, cfg, params, tokens, _ = _setup("qwen3-moe-235b-a22b")
    cfg = cfg.with_(moe_capacity_factor=1.0)
    route = models.moe.route
    runs = []
    for use_pallas in (True, False):
        with cs.RouteRecorder() as rec:
            models.prefill_forward(cfg.with_(use_pallas=use_pallas), params,
                                   torch.from_numpy(tokens))
        runs.append(rec.calls)
    assert models.moe.route is route
    assert [len(calls) for calls in runs] == [cfg.num_layers] * 2
    assert cs.route_flips(cfg, *runs, S) == ([], set())

    calls = runs[0]
    x, idx = calls[0]["x"], calls[0]["idx"]
    C = models.moe.capacity(cfg, idx.shape[0])
    dropped = int((~cs._kept(idx, C, cfg.num_experts)).sum())
    layer0 = {k: v[0] for k, v in params["layers"].items()}
    assert dropped == int(models.moe.moe_ffn_sorted(cfg, layer0, x)[1]["dropped"])

    token = S + 3  # row 1
    flipped = idx.clone()
    spare = [e for e in range(cfg.num_experts) if e not in flipped[token].tolist()][0]
    flipped[token, -1] = spare
    changed = [dict(calls[0], idx=flipped)] + calls[1:]
    flips, rows = cs.route_flips(cfg, changed, runs[1], S)
    assert 1 in rows
    first = [f for f in flips if f["token"] == token]
    assert len(first) == 1 and first[0]["picks_differ"] and first[0]["first"]
    assert first[0]["layer"] == 0 and first[0]["router_input_within_2e-3"]
    assert all(f["picks_differ"] == (f["token"] == token) for f in flips)
