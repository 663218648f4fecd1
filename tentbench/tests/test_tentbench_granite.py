"""The granite-4.0-h-small cell: its files load, its plain reference agrees
with the port at the port's smoke size, its FLOPs match a hand count, and
a whole run of the cell at that size is `correct` with the float8 control
reading far above it, and each fault the other cells are held to makes it
not `correct`."""
import copy
import json

import pytest
import torch
from conftest import ROOT
from test_tentbench_faults import FAULTS

from tentbench import check, harness
from tentbench.generator import Traffic, derived_seed
from tentbench.reference import granite_hybrid

NAME = "granite-4.0-h-small.pd_ttft"
# repro_torch.configs.granite_4_0_h_small.SMOKE, in the file's keys
SMOKE = {"num_hidden_layers": 3, "hidden_size": 256, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 128, "shared_intermediate_size": 256,
         "num_local_experts": 4, "num_experts_per_tok": 2, "mamba_n_heads": 8,
         "mamba_d_state": 32, "vocab_size": 1024, "layer_types": ["mamba", "attention", "mamba"]}


def smoke_cell() -> "harness.Cell":
    cell = copy.copy(harness.load_cell(NAME, ROOT))
    cell.conf = {**cell.conf, **SMOKE}
    cell.traffic = Traffic({"loop": "closed", "batch": 1, "prompt_lengths": [64, 128, 192],
                            "n_new": 2, "why": "smoke"})
    cell.spec = {**cell.spec, "sample": {"cache_calls": 2, "gap_rows": 3}}
    return cell


def test_files_load_and_match_the_port():
    from repro_torch.configs import ModelConfig, get_config, get_smoke_config

    cell = harness.load_cell(NAME, ROOT)
    assert cell.family is granite_hybrid and cell.chips == 1 and cell.dtype == torch.bfloat16
    assert cell.traffic.batch == 1 and cell.traffic.n_new == 2
    assert set(cell.spec["limits"]) == set(check.NAMES)
    full = ModelConfig(**granite_hybrid.port_config(cell.conf))
    assert full == get_config("granite-4.0-h-small").with_(source="")
    small = ModelConfig(**granite_hybrid.port_config(smoke_cell().conf))
    assert small == get_smoke_config("granite-4.0-h-small").with_(name=small.name, source="")
    catalog = {"num_hidden_layers": 40, "hidden_size": 4096, "num_local_experts": 72,
               "num_experts_per_tok": 10, "vocab_size": 100352, "mamba_chunk_size": 256}
    assert {k: cell.conf[k] for k in catalog} == catalog and cell.conf["changed_from_source"] == {}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert {c["name"]: c["reduced"] for c in bench["configs"]}["granite-4.0-h-small"] == []
    assert "ttft_p90_ms" in cell.e2e and "mfu_pct.ttft" in cell.per_layer


@pytest.mark.parametrize("use_pallas", [False, True])
def test_reference_agrees_with_the_port_in_float32(use_pallas):
    from repro_torch.configs import ModelConfig
    from repro_torch.models import prefill_forward
    from repro_torch.serving import greedy_decode

    cell = smoke_cell()
    gen = torch.Generator().manual_seed(derived_seed(3, 1))
    params = granite_hybrid.make_params(cell.conf, gen, torch.float32)
    cfg = ModelConfig(**granite_hybrid.port_config(cell.conf), use_pallas=use_pallas,
                      remat="none")
    S, n_new = 96, 4
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=gen)
    with torch.no_grad():
        logits, kv = prefill_forward(cfg, params, tokens)
        cache = harness.grow(cfg, kv, S + n_new)
        served = torch.as_tensor(greedy_decode(cfg, params, cache, logits, S, n_new))
        ref_logits, ref_shipped, ref_decoded = granite_hybrid.forward(
            cell.conf, params, torch.cat([tokens, served[:, :-1].long()], 1), S)
    assert check.rel_err(logits, ref_logits[:, 0]) < 1e-5
    got_shipped, got_decoded = granite_hybrid.program_caches(kv, cache, S, S + n_new - 1)
    assert set(got_shipped) == set(ref_shipped) == {"k", "v", "ssm_state", "conv_buf"}
    assert check.cache_err(got_shipped, ref_shipped) < 1e-4
    assert check.cache_err(got_decoded, ref_decoded) < 1e-4
    for b in range(2):
        assert check.token_gap(ref_logits[b], served[b]) == 0.0


def test_flops_equal_a_hand_count():
    """The full configuration at a 256-token prompt and one decode step, each
    term written out from the published sizes."""
    conf = harness.load_cell(NAME, ROOT).conf
    D, V, S = 4096, 100352, 256
    ffn = 2 * D * 72 + 10 * 3 * 2 * D * 768 + 3 * 2 * D * 1536
    attn = 2 * (D * 4096 + 2 * D * 1024 + 4096 * D)
    mamba = 2 * D * (2 * 8192 + 2 * 128 + 128) + 2 * 8192 * D + 2 * 4 * 8448
    pairs = 2 * (128 * 129 / 2)  # two chunks of 128, each product over its causal half
    ssd = 2 * 128 * pairs + 128 * (2 * 64 * pairs + 4.0 * S * 64 * 128)
    prefill = S * (40 * ffn + 4 * attn + 36 * mamba) + 4 * 4 * 4096 * S * (S + 1) / 2
    prefill += 36 * ssd + 2 * D * V
    step = 40 * ffn + 4 * (attn + 4 * 4096 * (S + 1)) + 36 * (mamba + 4 * 128 * 64 * 128)
    step += 2 * D * V
    assert granite_hybrid.flops(conf, 1, S, 2) == pytest.approx(prefill + step, rel=1e-12)
    assert granite_hybrid.flops(conf, 3, S, 2) == pytest.approx(3 * (prefill + step), rel=1e-12)


def test_a_smoke_run_is_correct_and_the_control_reads_far_above_it():
    from tentbench.control import control_readings

    cell = smoke_cell()
    res = harness.run_cell(cell, 11, 0.3, False, "cpu", emit=lambda obj: None)
    assert res["correct"] and res["checks"]["shipped_differ"]["value"] == 0
    ctl = control_readings(cell, 11, "cpu")
    for key in ("prefill_cache_err", "decode_cache_err"):
        assert ctl[key] >= 3 * res["checks"][key]["value"] > 0, (key, ctl, res["checks"])


@pytest.mark.parametrize("fault", sorted(set(FAULTS) - {"half_batch"}))  # a batch of one
def test_fault_makes_the_run_incorrect(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = harness.run_cell(smoke_cell(), 5, 0.3, False, "cpu", emit=lambda obj: None)
    assert not res["correct"], res["checks"]
