"""The deepseek-v3 cell: its files load, its plain reference agrees with the
port at the port's smoke size holding an expert share, its FLOPs and
`mla_roofline_pct`'s bound match hand counts, and a whole run of the cell at
that size is `correct` with the float8 control reading far above it, and
each fault the other cells are held to makes it not `correct`."""
import copy
import importlib.util
import json
import math

import pytest
import torch
from conftest import ROOT
from test_tentbench_faults import FAULTS

from tentbench import check, harness
from tentbench.generator import Traffic, derived_seed
from tentbench.reference import deepseek_v3

NAME = "deepseek-v3.pd_ttft"
# repro_torch.configs.deepseek_v3.SMOKE, in the file's keys
SMOKE = {"num_hidden_layers": 3, "hidden_size": 256, "num_attention_heads": 4,
         "num_key_value_heads": 4, "moe_intermediate_size": 64, "intermediate_size": 256,
         "vocab_size": 1024, "n_routed_experts": 16, "router_experts": 16,
         "num_experts_per_tok": 4, "n_group": 4, "topk_group": 2, "first_k_dense_replace": 1,
         "q_lora_rank": 96, "kv_lora_rank": 64, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
         "v_head_dim": 32}
# the smoke size's second share of four, as the cell holds one of 32
SHARE = {"n_routed_experts": 4, "first_held_expert": 4}


def smoke_cell() -> "harness.Cell":
    cell = copy.copy(harness.load_cell(NAME, ROOT))
    cell.conf = {**cell.conf, **SMOKE, **SHARE}
    cell.traffic = Traffic({"loop": "closed", "batch": 1, "prompt_lengths": [64, 128, 192],
                            "n_new": 2, "why": "smoke"})
    cell.spec = {**cell.spec, "sample": {"cache_calls": 2, "gap_rows": 3}}
    return cell


def _mla_metric():
    spec = importlib.util.spec_from_file_location(
        "mla_roofline_pct", ROOT / "tentbench/metrics/mla_roofline_pct.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_files_load_and_match_the_port():
    from repro_torch.configs import ModelConfig, get_config, get_smoke_config

    cell = harness.load_cell(NAME, ROOT)
    assert cell.family is deepseek_v3 and cell.chips == 1 and cell.dtype == torch.bfloat16
    assert cell.traffic.batch == 1 and cell.traffic.n_new == 2
    assert set(cell.spec["limits"]) == set(check.NAMES)
    full = ModelConfig(**deepseek_v3.port_config(cell.conf))
    assert full == get_config("deepseek-v3").with_(num_layers=48, num_experts=8,
                                                   router_experts=256, source="")
    small = ModelConfig(**deepseek_v3.port_config({**cell.conf, **SMOKE}))
    assert small == get_smoke_config("deepseek-v3").with_(name=small.name, source="")
    share = ModelConfig(**deepseek_v3.port_config(smoke_cell().conf))
    assert share == small.with_(num_experts=4, first_expert=4, router_experts=16)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    reduced = {c["name"]: c["reduced"] for c in bench["configs"]}["deepseek-v3"]
    assert sorted(reduced) == sorted(cell.conf["changed_from_source"]) == [
        "n_routed_experts", "num_hidden_layers"]
    # every other number of the published config.json as it is
    published = {"hidden_size": 7168, "num_attention_heads": 128, "q_lora_rank": 1536,
                 "kv_lora_rank": 512, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
                 "v_head_dim": 128, "moe_intermediate_size": 2048, "intermediate_size": 18432,
                 "vocab_size": 129280, "num_experts_per_tok": 8, "n_group": 8, "topk_group": 4,
                 "first_k_dense_replace": 3, "routed_scaling_factor": 2.5}
    assert {k: cell.conf[k] for k in published} == published
    assert (cell.conf["num_hidden_layers"], cell.conf["n_routed_experts"],
            cell.conf["router_experts"]) == (48, 8, 256)
    assert "ttft_p90_ms" in cell.e2e and "mla_roofline_pct" in cell.per_layer


@pytest.mark.parametrize("use_pallas", [False, True])
def test_reference_agrees_with_the_port_in_float32(use_pallas):
    """The share's prefill logits and both cache leaves, then decode steps
    through the grown cache, against the reference's full forward; the
    reference's caches are laid out as `program_caches` reads the
    program's."""
    from repro_torch.configs import ModelConfig
    from repro_torch.models import prefill_forward
    from repro_torch.serving import greedy_decode

    cell = smoke_cell()
    gen = torch.Generator().manual_seed(derived_seed(3, 1))
    params = deepseek_v3.make_params(cell.conf, gen, torch.float32)
    cfg = ModelConfig(**deepseek_v3.port_config(cell.conf), use_pallas=use_pallas, remat="none")
    S, n_new = 96, 4
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=gen)
    with torch.no_grad():
        logits, kv = prefill_forward(cfg, params, tokens)
        cache = harness.grow(cfg, kv, S + n_new)
        served = torch.as_tensor(greedy_decode(cfg, params, cache, logits, S, n_new))
        ref_logits, ref_shipped, ref_decoded = deepseek_v3.forward(
            cell.conf, params, torch.cat([tokens, served[:, :-1].long()], 1), S)
    # float32 on both sides, summed in other orders: 1e-5 is a few hundred ulps
    assert check.rel_err(logits, ref_logits[:, 0]) < 1e-5
    got_shipped, got_decoded = deepseek_v3.program_caches(kv, cache, S, S + n_new - 1)
    assert {n: t.shape for n, t in got_shipped.items()} == {
        n: t.shape for n, t in ref_shipped.items()} == {
        "k": (3, 2, S, 1, 16), "v": (3, 2, S, 1, 64)}
    assert check.cache_err(got_shipped, ref_shipped) < 1e-5
    assert check.cache_err(got_decoded, ref_decoded) < 1e-5
    for b in range(2):
        assert check.token_gap(ref_logits[b], served[b]) == 0.0


def test_flops_equal_a_hand_count():
    """The cell's configuration at a 256-token prompt and one decode step,
    each term written out from the published sizes."""
    conf = harness.load_cell(NAME, ROOT).conf
    D, V, S, H = 7168, 129280, 256, 128
    proj = 2 * (D * 1536 + 1536 * H * 192 + D * 576 + H * 128 * D)
    kv_b = 2 * 512 * H * 256
    ffn = 3 * 6 * D * 18432 + 45 * (2 * D * 256 + (8 * 8 / 256) * 6 * D * 2048 + 6 * D * 2048)
    prefill = S * (48 * (proj + kv_b) + ffn) + 48 * 2 * H * 320 * S * (S + 1) / 2 + 2 * D * V
    step = 48 * (proj + 2 * H * 128 * 512 + 2 * H * (1024 + 64) * (S + 1) + 2 * H * 512 * 128)
    step += ffn + 2 * D * V
    assert deepseek_v3.flops(conf, 1, S, 2) == pytest.approx(prefill + step, rel=1e-12)
    assert deepseek_v3.flops(conf, 2, S, 2) == pytest.approx(2 * (prefill + step), rel=1e-12)


def test_mla_bound_at_a_known_shape():
    """At 8,192 tokens, 128 heads of q/k 192 and v 128 in bf16: 2 x 320
    flops a live pair and head, 2.75 TFLOP, 2.78 ms at 989 TFLOP/s, bound
    by operations; a cell without `v_head_dim` reads nothing."""
    mod = _mla_metric()
    S = 8192
    ms, by = mod.mla_bound(1, S, 128, 128, 192, torch.bfloat16, 0, 128)
    assert by == "operations"
    assert ms == pytest.approx(2 * 320 * S * (S + 1) / 2 * 128 / 989e12 * 1e3, rel=1e-12)
    assert math.isclose(ms, 2.78, abs_tol=0.005)
    assert mod.read(harness.Run(cell=harness.load_cell("qwen2-0.5b.pd_ttft", ROOT), calls=[],
                                window_s=1.0, setup_s=0.0)) is None


def test_a_smoke_run_is_correct_and_the_control_reads_far_above_it():
    from tentbench.control import control_readings

    cell = smoke_cell()
    res = harness.run_cell(cell, 2**31 + 11, 0.3, False, "cpu", emit=lambda obj: None)
    assert res["correct"] and res["checks"]["shipped_differ"]["value"] == 0
    ctl = control_readings(cell, 2**31 + 11, "cpu")
    for key in ("prefill_cache_err", "decode_cache_err"):
        assert ctl[key] >= 3 * res["checks"][key]["value"] > 0, (key, ctl, res["checks"])


@pytest.mark.parametrize("fault", sorted(set(FAULTS) - {"half_batch"}))  # a batch of one
def test_fault_makes_the_run_incorrect(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = harness.run_cell(smoke_cell(), 5, 0.3, False, "cpu", emit=lambda obj: None)
    assert not res["correct"], res["checks"]
