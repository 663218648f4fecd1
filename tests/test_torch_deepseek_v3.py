"""deepseek-v3 in the port, on the CPU at smoke size: multi-head latent
attention with a latent cache, YaRN rope, a dense first layer, and MoE
layers with sigmoid, bias-steered, group-limited routing over the experts a
layer holds.

The port is held against the benchmark's plain float32 reference
(`tentbench/reference/deepseek_v3.py`), which imports nothing of the port:
prefill's logits and both cache leaves, the disaggregated handoff through a
`TentEngine` byte for byte and the decode steps after it, the router's
picks, YaRN's frequencies, and the expert shares, which add up to the uncut
layer. No JAX here: the JAX package has no counterpart of this model.
"""
import json
import math
from pathlib import Path

import pytest
import torch

from pd_handoff import pd_engine, ship
from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.models import cache_shapes, decode_step, prefill_forward
from repro_torch.models import moe
from repro_torch.models.common import swiglu, yarn_inv_freq
from repro_torch.obs import spans
from repro_torch.serving import bytes_to_tree, greedy_decode, tree_to_bytes
from tentbench.reference import deepseek_v3 as ref
from tentbench.reference.common import Precision, rel_err

ROOT = Path(__file__).resolve().parents[1]
CONF = json.loads((ROOT / "tentbench/configs/deepseek-v3.json").read_text())
# SMOKE in the source's keys, every expert held
SMOKE_CONF = {**CONF, "num_hidden_layers": 3, "hidden_size": 256, "num_attention_heads": 4,
              "num_key_value_heads": 4, "moe_intermediate_size": 64, "intermediate_size": 256,
              "vocab_size": 1024, "n_routed_experts": 16, "router_experts": 16,
              "num_experts_per_tok": 4, "n_group": 4, "topk_group": 2,
              "first_k_dense_replace": 1, "q_lora_rank": 96, "kv_lora_rank": 64,
              "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32}
S, N_NEW = 40, 4
# float32 on both sides, summed in other orders: a few hundred ulps
TOL_F32 = 1e-5
# bf16 rounds each product's output, each norm and the residual stream (2^-8
# a rounding); through the three layers the worst logits and cache leaf read
# 0.029 over six seeds, with the routing made decisive so that no pick flips.
# A flipped pick reads 0.3-0.5, a left-out rope or latent norm far more
TOL_BF16 = 5e-2


def _cfg(use_pallas: bool = False) -> ModelConfig:
    return get_smoke_config("deepseek-v3").with_(use_pallas=use_pallas, remat="none")


def _params(seed: int, dtype=torch.float32, decisive: bool = False) -> dict:
    """The reference's draw at smoke size; `decisive`: the choice's bias
    +2 on experts 4, 5, 8 and 9 (two in each of two groups), so every token
    picks those four and rounding cannot flip a pick."""
    params = ref.make_params(SMOKE_CONF, torch.Generator().manual_seed(seed), dtype)
    if decisive:
        bias = torch.zeros(16)
        bias[[4, 5, 8, 9]] = 2.0
        params["layers"]["router_bias"] = bias.expand(2, 16).to(dtype).clone()
    return params


def _tokens(seed: int, batch: int = 2, length: int = S) -> torch.Tensor:
    return torch.randint(0, 1024, (batch, length), generator=torch.Generator().manual_seed(seed))


def _caches_err(got: dict, want: dict) -> float:
    assert set(got) == set(want) == {"k", "v"}
    return max(rel_err(got[n][i].float(), want[n][i]) for n in want
               for i in range(want[n].shape[0]))


def test_the_configs_are_the_reference_s():
    assert ModelConfig(**ref.port_config(SMOKE_CONF), remat="none") == _cfg().with_(
        name=SMOKE_CONF["name"], source="")
    assert ModelConfig(**ref.port_config(CONF)) == get_config("deepseek-v3").with_(
        num_layers=48, num_experts=8, router_experts=256, source="")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_the_reference(use_pallas, dtype):
    """Last-token logits and both cache leaves, layer by layer, against the
    float32 reference over the same weights."""
    bf16 = dtype == torch.bfloat16
    params, tokens = _params(1, dtype, decisive=bf16), _tokens(2)
    with torch.no_grad():
        logits, cache = prefill_forward(_cfg(use_pallas), params, tokens)
        want_logits, want_cache, _ = ref.forward(SMOKE_CONF, params, tokens, S)
    assert {n: (tuple(t.shape), t.dtype) for n, t in cache.items()} == {
        "k": ((3, 2, S, 1, 16), dtype), "v": ((3, 2, S, 1, 64), dtype)}
    tol = TOL_BF16 if bf16 else TOL_F32
    assert rel_err(logits, want_logits[:, 0]) < tol
    assert _caches_err(cache, want_cache) < tol


def _handoff(params, cache: dict) -> dict:
    """The cache through `tree_to_bytes`, `ship_kv` on the PD scenario's
    engine under a rail flap and `bytes_to_tree`, byte for byte."""
    data, _ = tree_to_bytes(cache)
    assert data.size == sum(t.numel() * t.element_size() for t in cache.values())
    dst, res = ship(pd_engine(), data, flap=True, params=params)
    assert res.ok
    shipped = bytes_to_tree(dst.read(0, data.size), cache)
    assert all(torch.equal(shipped[n], cache[n]) for n in cache)
    return shipped


@pytest.mark.parametrize("use_pallas", [False, True])
def test_handoff_and_decode_match_the_reference(use_pallas):
    """Prefill, the handoff, then decode steps through the shipped cache in
    the absorbed form: each step's logits and the latents and rope keys the
    steps wrote against the reference's full forward over the prompt and
    the served tokens."""
    params, tokens = _params(3), _tokens(4)
    cfg = _cfg(use_pallas)
    with torch.no_grad():
        logits, kv = prefill_forward(cfg, params, tokens)
        shipped = _handoff(params, kv)
        cache = {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, N_NEW)) for n, t in shipped.items()}
        served = torch.as_tensor(greedy_decode(cfg, params, {n: t.clone() for n, t in
                                                             cache.items()}, logits, S, N_NEW))
        steps = [logits]
        for i in range(N_NEW - 1):
            step_logits, cache = decode_step(cfg, params, cache, served[:, i:i + 1], S + i)
            steps.append(step_logits)
        want_logits, _, want_decoded = ref.forward(
            SMOKE_CONF, params, torch.cat([tokens, served[:, :-1].long()], 1), S)
    assert rel_err(torch.stack(steps, 1), want_logits) < TOL_F32
    _, got_decoded = ref.program_caches(shipped, cache, S, S + N_NEW - 1)
    assert _caches_err(got_decoded, want_decoded) < TOL_F32
    assert torch.equal(served, want_logits.argmax(-1).to(served.dtype))


def _logit(p: float) -> float:
    return math.log(p / (1 - p))


# sigmoid scores of 16 experts in 4 groups of 4: group 0 holds the highest
# score (expert 0) but the lowest sum of two (1.00); groups 1 (1.50) and 2
# (1.47) are kept
SCORES = [0.95, 0.05, 0.05, 0.05, 0.8, 0.7, 0.1, 0.1, 0.75, 0.72, 0.1, 0.1, 0.6, 0.55, 0.1, 0.1]


@pytest.mark.parametrize("case", ["group_mask", "bias"])
def test_routing_picks(case):
    """`group_mask`: the highest score's group is dropped, so expert 0 is
    not picked; the picks are 4, 8, 9, 5 in descending order. `bias`: +0.64
    on expert 6 lifts its choice score (0.1 + 0.64) past expert 5's 0.7, so
    6 replaces 5; its gate is still its sigmoid score, 0.1. Gates are the
    scores over their sum, times 2.5. The reference's router picks alike."""
    x = torch.tensor([[_logit(p) for p in SCORES]], dtype=torch.float32)
    bias = torch.zeros(16)
    if case == "bias":
        bias[6] = 0.64
    cfg = _cfg()
    gates, idx, _ = moe.route_tokens(cfg, {"router": torch.eye(16), "router_bias": bias}, x)
    want = [4, 8, 9, 5] if case == "group_mask" else [4, 8, 6, 9]
    assert idx[0].tolist() == want
    s = torch.tensor([SCORES[e] for e in want])
    assert torch.allclose(gates[0], s / s.sum() * 2.5, rtol=1e-6)
    d = ref.dims(SMOKE_CONF)
    ref_idx, ref_gates = ref._route(x, torch.eye(16), bias, d, 2.5, Precision())
    assert ref_idx[0].tolist() == want and torch.allclose(ref_gates, gates, rtol=1e-6)


def test_yarn_frequencies_are_the_formula_s():
    """DeepSeek-V3's rope: 64 dims, theta 1e4, factor 40 over 4,096
    positions, beta_fast 32 and beta_slow 1. The ramp runs from dim pair 10
    to 23 (floor 10.47, ceil 22.51): below it the plain frequency, above it
    the plain one over 40, between them linear."""
    dim, theta = 64, 1e4
    bound = [dim * math.log(4096 / (b * 2 * math.pi)) / (2 * math.log(theta)) for b in (32, 1)]
    assert (round(bound[0], 2), round(bound[1], 2)) == (10.47, 22.51)
    got = yarn_inv_freq(dim, theta, 40.0, 4096, 32.0, 1.0)
    for i in range(dim // 2):
        extra = theta ** (-2 * i / dim)
        ramp = min(max((i - 10) / 13, 0.0), 1.0)
        want = extra / 40 * ramp + extra * (1 - ramp)
        assert got[i].item() == pytest.approx(want, rel=1e-6), i
    assert got[10].item() == pytest.approx(theta ** (-20 / 64), rel=1e-6)
    assert got[23].item() == pytest.approx(theta ** (-46 / 64) / 40, rel=1e-6)


def test_the_shares_add_up_to_the_uncut_layer():
    """The MoE layer cut into 4 shares of 4 experts, as expert parallelism
    cuts it: each share routes over all 16 experts and computes only its
    own; the shares' parts, with the shared expert counted once, add up to
    the reference's uncut layer, and their held pairs to every pair."""
    params = _params(5)
    lp = {n: t[0] for n, t in params["layers"].items()
          if n.startswith(("router", "w_", "shared_"))}
    x = torch.randn(96, 256, generator=torch.Generator().manual_seed(6))
    cfg = _cfg()
    parts, held = [], 0
    with torch.no_grad():
        for r in range(4):
            share = cfg.with_(num_experts=4, first_expert=4 * r, router_experts=16)
            p = {n: t[4 * r:4 * r + 4] if n in ("w_gate", "w_up", "w_down") else t
                 for n, t in lp.items()}
            out, aux = moe.moe_ffn_dropless(share, p, x)
            parts.append(out)
            held += int(aux["held_pairs"])
        shared = swiglu(x, lp["shared_gate"], lp["shared_up"], lp["shared_down"])
        want = ref._moe({n: t[None] for n, t in lp.items()}, 0, x, ref.dims(SMOKE_CONF),
                        2.5, Precision())
        whole, _ = moe.moe_ffn_dropless(cfg, lp, x)
    assert held == 96 * cfg.experts_per_token
    assert all(part.abs().sum() > 0 for part in parts)
    assert rel_err(sum(parts) + shared, want) < TOL_F32
    assert rel_err(whole + shared, want) < TOL_F32


def test_a_share_counts_its_held_pairs_on_the_moe_span():
    """With a recorder attached, `model.moe` counts the pairs on held
    experts, read from the device, beside every routed pair; `model.mla`
    spans one a layer, and `model.prefill`'s cache bytes are the latent's
    and the rope key's."""
    cfg = _cfg().with_(num_experts=4, first_expert=8, router_experts=16)
    params = _params(7)
    for n in ("w_gate", "w_up", "w_down"):
        params["layers"][n] = params["layers"][n][:, 8:12].contiguous()
    tokens = _tokens(8)
    rec = spans.attach()
    try:
        with rec.request(keep=True) as root:
            with torch.no_grad():
                _, cache = prefill_forward(cfg, params, tokens)
        got = rec.take(root.request)
    finally:
        spans.detach()
    prefill = next(s for s in got if s.name == "model.prefill")
    assert prefill.counters["cache_kv_bytes"] == 3 * 2 * S * (64 + 16) * 4
    assert [s.parent for s in got if s.name == "model.mla"] == [prefill.id] * 3
    moes = [s for s in got if s.name == "model.moe"]
    assert len(moes) == 2
    for s in moes:
        assert s.counters["routed_pairs"] == 2 * S * 4
        assert 0 < s.counters["held_pairs"] < s.counters["routed_pairs"]


def test_cache_and_params_at_the_cell_s_cut():
    """The cell's cut: 48 layers, 8 experts held of 256: 29,943,154,944
    parameters (59.89 GB in bf16) and 55,296 B of cache a token."""
    cfg = get_config("deepseek-v3").with_(num_layers=48, num_experts=8, router_experts=256)
    assert cfg.param_count() == 29_943_154_944
    shapes = {n: (tuple(t.shape), t.dtype) for n, t in cache_shapes(cfg, 1, 512).items()}
    assert shapes == {"k": ((48, 1, 512, 1, 64), torch.bfloat16),
                      "v": ((48, 1, 512, 1, 512), torch.bfloat16)}
    nbytes = sum(t.numel() * t.element_size() for t in cache_shapes(cfg, 1, 8192).values())
    assert nbytes == 8192 * 55_296
    with pytest.raises(ValueError, match="dropless"):
        cfg.with_(moe_capacity_factor=1.25)
