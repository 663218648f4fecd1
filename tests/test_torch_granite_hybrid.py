"""granite-4.0-h-small in the port, on the CPU at smoke size: Mamba2 and
NoPE attention layers by `layer_types`, a dropless MoE with a shared
expert, and a cache of two kinds of state with different layer counts.

The port is held against the benchmark's plain float32 reference
(`tentbench/reference/granite_hybrid.py`), which imports nothing of the
port: prefill's logits and cache, the disaggregated handoff through a
`TentEngine` and the decode steps after it, and the routed experts against
the reference's one-expert-at-a-time loop. No JAX here: the JAX package has
no counterpart of this model.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pd_handoff import pd_engine, ship
from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.models import (cache_shapes, decode_step, init_params, param_shapes,
                                prefill_forward)
from repro_torch.models import moe
from repro_torch.models.common import swiglu
from repro_torch.serving import bytes_to_tree, greedy_decode, tree_to_bytes
from tentbench.reference import granite_hybrid as ref
from tentbench.reference.common import rel_err

ROOT = Path(__file__).resolve().parents[1]
CONF = json.loads((ROOT / "tentbench/configs/granite-4.0-h-small.json").read_text())
# SMOKE in the source's keys
SMOKE_CONF = {**CONF, "num_hidden_layers": 3, "hidden_size": 256, "num_attention_heads": 4,
              "num_key_value_heads": 2, "intermediate_size": 128,
              "shared_intermediate_size": 256, "num_local_experts": 4, "num_experts_per_tok": 2,
              "mamba_n_heads": 8, "mamba_d_state": 32, "vocab_size": 1024,
              "layer_types": ["mamba", "attention", "mamba"]}
S, N_NEW = 72, 4


def _cfg(use_pallas: bool = False) -> ModelConfig:
    return get_smoke_config("granite-4.0-h-small").with_(use_pallas=use_pallas, remat="none")


@pytest.fixture(scope="module")
def model():
    gen = torch.Generator().manual_seed(27)
    params = ref.make_params(SMOKE_CONF, gen, torch.float32)
    tokens = torch.randint(0, 1024, (2, S), generator=gen)
    return params, tokens


def _caches_err(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(rel_err(got[n][i], want[n][i]) for n in want for i in range(want[n].shape[0]))


def test_the_smoke_config_is_the_reference_s():
    assert ModelConfig(**ref.port_config(SMOKE_CONF), remat="none") == _cfg().with_(
        name=SMOKE_CONF["name"], source="")
    assert ModelConfig(**ref.port_config(CONF)) == get_config("granite-4.0-h-small").with_(
        source="")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_the_reference(model, use_pallas):
    """Last-token logits and every cache leaf, layer by layer."""
    params, tokens = model
    with torch.no_grad():
        logits, cache = prefill_forward(_cfg(use_pallas), params, tokens)
        want_logits, want_cache, _ = ref.forward(SMOKE_CONF, params, tokens, S)
    assert rel_err(logits, want_logits[:, 0]) < 1e-5
    assert _caches_err(cache, want_cache) < 1e-5


def _handoff(params, cache: dict) -> dict:
    """The cache through `tree_to_bytes`, `ship_kv` on the PD scenario's
    engine and `bytes_to_tree`."""
    data, _ = tree_to_bytes(cache)
    dst, res = ship(pd_engine(), data, params=params)
    assert res.ok
    shipped = bytes_to_tree(dst.read(0, data.size), cache)
    assert all(torch.equal(shipped[n], cache[n]) for n in cache)
    return shipped


@pytest.mark.parametrize("use_pallas", [False, True])
def test_handoff_and_decode_match_the_reference(model, use_pallas):
    """Prefill, the handoff, then decode steps through the shipped cache:
    each step's logits and the cache the steps wrote against the
    reference's full forward over the prompt and the served tokens."""
    params, tokens = model
    cfg = _cfg(use_pallas)
    with torch.no_grad():
        logits, kv = prefill_forward(cfg, params, tokens)
        shipped = _handoff(params, kv)
        cache = {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, N_NEW)) if n in ("k", "v")
                 else t.clone() for n, t in shipped.items()}
        served = torch.as_tensor(greedy_decode(cfg, params, {n: t.clone() for n, t in
                                                             cache.items()}, logits, S, N_NEW))
        steps = [logits]
        for i in range(N_NEW - 1):
            step_logits, cache = decode_step(cfg, params, cache, served[:, i:i + 1], S + i)
            steps.append(step_logits)
        want_logits, _, want_decoded = ref.forward(
            SMOKE_CONF, params, torch.cat([tokens, served[:, :-1].long()], 1), S)
    assert rel_err(torch.stack(steps, 1), want_logits) < 1e-5
    _, got_decoded = ref.program_caches(shipped, cache, S, S + N_NEW - 1)
    assert _caches_err(got_decoded, want_decoded) < 1e-5
    assert torch.equal(served, want_logits.argmax(-1).to(served.dtype))


# each mixer's and FFN's last projection: residual_multiplier m scales them by m
_OUT_LEAVES = ("wo", "ssm_out", "w_down", "shared_down")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m", "hymba-1.5b",
                                  "qwen3-moe-235b-a22b", "granite-4.0-h-small"])
def test_the_multipliers_act_on_every_layer_kind(arch):
    """residual_multiplier m and attention_multiplier c on any config give
    what its default does with each output projection times m and wq (and
    bq) times c * sqrt(head_dim): in prefill's logits and cache and in a
    decode step after it."""
    base = get_smoke_config(arch).with_(remat="none", residual_multiplier=1.0,
                                        attention_multiplier=0.0)
    params = init_params(base, torch.Generator().manual_seed(3), torch.float32, device="cpu")
    m, c = 0.3, 0.05
    scaled = base.with_(residual_multiplier=m, attention_multiplier=c)
    folded = {**params, "layers": dict(params["layers"])}
    for name in _OUT_LEAVES:
        if name in folded["layers"]:
            folded["layers"][name] = folded["layers"][name] * m
    for name in ("wq", "bq"):
        if name in folded["layers"] and base.num_heads:
            folded["layers"][name] = folded["layers"][name] * (c * base.resolved_head_dim ** 0.5)
    tokens = torch.randint(0, base.vocab_size, (2, 24), generator=torch.Generator().manual_seed(4))
    got, want = [], []
    with torch.no_grad():
        for cfg, p, out in ((scaled, params, got), (base, folded, want)):
            logits, cache = prefill_forward(cfg, p, tokens)
            if "k" in cache:
                cache = {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1)) if n in ("k", "v")
                         else t for n, t in cache.items()}
            step, _ = decode_step(cfg, p, {n: t.clone() for n, t in cache.items()},
                                  logits.argmax(-1, keepdim=True), tokens.shape[1])
            out.extend([logits, step, *(cache[n] for n in sorted(cache))])
    assert len(got) == len(want) > 2
    assert max(rel_err(a, b) for a, b in zip(got, want)) < 1e-5


def test_an_encoder_decoder_takes_no_multipliers():
    with pytest.raises(ValueError, match="encoder"):
        get_smoke_config("seamless-m4t-medium").with_(residual_multiplier=0.5)


def _layer0(params) -> dict:
    return {n: params["layers"][n][0] for n in ("router", "w_gate", "w_up", "w_down",
                                                  "shared_gate", "shared_up", "shared_down")}


@pytest.mark.parametrize("routing", ["drawn", "one_expert_over_capacity"])
def test_dropless_moe_matches_the_per_expert_loop(model, routing):
    """Routed experts plus the shared expert against the reference's
    top-k-then-softmax loop over experts. In the second routing every token
    ranks expert 0 first, far more pairs than the capacity path keeps: it
    drops them, the dropless path computes them all."""
    params, _ = model
    cfg = _cfg()
    p = _layer0(params)
    T = 96
    x = torch.randn(T, cfg.d_model, generator=torch.Generator().manual_seed(5))
    if routing == "one_expert_over_capacity":
        x = x + 1.0
        p["router"] = p["router"].clone()
        p["router"][:, 0] = 0.1  # expert 0's logit near 0.1 * D for every token
    d = ref.dims(SMOKE_CONF)
    with torch.no_grad():
        routed, aux = moe.moe_ffn_dropless(cfg, p, x)
        got = routed + swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"])
        want = ref._moe({n: t[None] for n, t in p.items()}, 0, x, d, ref.Precision())
        _, capped = moe.moe_ffn_sorted(cfg.with_(moe_capacity_factor=1.25), p, x)
    assert rel_err(got, want) < 1e-5
    _, idx, _ = moe.route(x, p["router"], cfg.experts_per_token)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts).tolist()
    assert sum(counts) == T * cfg.experts_per_token and int(aux["dropped"]) == 0
    C = moe.capacity(cfg.with_(moe_capacity_factor=1.25), T)
    assert (int(capped["dropped"]) > 0) == (max(counts) > C)
    if routing == "one_expert_over_capacity":
        assert counts[0] == T > C


def test_grouped_and_looped_segments_agree():
    """The grouped product over contiguous expert segments gives each
    segment its own expert's SwiGLU, as a loop over the experts does; an
    expert with no pair is skipped."""
    gen = torch.Generator().manual_seed(9)
    E, D, F_ = 4, 64, 32
    w = [torch.randn(E, a, b, generator=gen).div(8) for a, b in ((D, F_), (D, F_), (F_, D))]
    counts = torch.tensor([5, 0, 9, 2])
    xs = torch.randn(16, D, generator=gen)
    got = moe.segments_grouped(xs, counts, *w, most=9)  # buckets as long as the longest
    want, start = torch.empty_like(xs), 0
    for e, n in enumerate(counts.tolist()):
        seg = xs[start:start + n]
        want[start:start + n] = swiglu(seg, w[0][e], w[1][e], w[2][e])
        start += n
    assert rel_err(got, want) < 1e-6


def test_grouped_segments_in_bf16_agree_with_the_loop():
    """bf16 goes through `torch._grouped_mm` (f32, above, through zero-padded
    per-expert buckets): each segment gets its own expert's SwiGLU, as
    a loop over the experts in bf16 gives it, within bf16's tolerance."""
    gen = torch.Generator().manual_seed(10)
    E, D, F_ = 4, 64, 32
    w = [torch.randn(E, a, b, generator=gen).div(8).to(torch.bfloat16)
         for a, b in ((D, F_), (D, F_), (F_, D))]
    counts = torch.tensor([3, 7, 0, 6])
    xs = torch.randn(16, D, generator=gen).to(torch.bfloat16)
    got = moe.segments_grouped(xs, counts, *w, most=7)
    want, start = torch.empty_like(xs), 0
    for e, n in enumerate(counts.tolist()):
        seg = xs[start:start + n]
        want[start:start + n] = swiglu(seg, w[0][e], w[1][e], w[2][e])
        start += n
    assert got.dtype == torch.bfloat16 and rel_err(got.float(), want.float()) < 2e-2


def test_the_dropless_moe_has_no_capacity():
    with pytest.raises(ValueError, match="dropless"):
        moe.capacity(_cfg(), 16)


def test_layer_counts_and_cache_leaves():
    cfg = get_config("granite-4.0-h-small")
    slots = cfg.layer_slots()
    assert [i for i, (kind, _) in enumerate(slots) if kind == "attention"] == [5, 15, 25, 35]
    assert (cfg.layers_of("mamba"), cfg.layers_of("attention")) == (36, 4)
    assert slots[35] == ("attention", 3) and slots[39] == ("mamba", 35)
    shapes = {n: (tuple(t.shape), t.dtype) for n, t in cache_shapes(cfg, 1, 512).items()}
    assert shapes == {"k": ((4, 1, 512, 8, 128), torch.bfloat16),
                      "v": ((4, 1, 512, 8, 128), torch.bfloat16),
                      "ssm_state": ((36, 1, 128, 64, 128), torch.float32),
                      "conv_buf": ((36, 1, 3, 8448), torch.bfloat16)}
    nbytes = sum(t.numel() * t.element_size() for t in cache_shapes(cfg, 1, 512).values())
    assert nbytes == 161_208_320
    lp = param_shapes(cfg)["layers"]
    assert lp["wq"][0] == 4 and lp["ssm_in"][0] == 36 and lp["w_gate"] == (40, 72, 4096, 768)
    assert lp["shared_down"] == (40, 1536, 4096)


def test_param_count_is_the_published_32b():
    cfg = get_config("granite-4.0-h-small")
    assert cfg.param_count() == 32_207_337_984
    shapes = param_shapes(cfg)
    leaves = [shapes["embed"], shapes["final_norm"], *shapes["layers"].values()]
    assert sum(int(np.prod(s)) for s in leaves) == 32_207_337_984
    assert cfg.param_count(active_only=True) == 32_207_337_984 - 40 * 62 * 3 * 4096 * 768
