"""The plain references against the port's plain path at the smoke sizes,
and the low-precision control against the program there."""
import pytest
import torch
from conftest import CELLS

from tentbench import check, harness
from tentbench.generator import derived_seed
from tentbench.reference.common import Precision


def _port(cell, params, use_pallas):
    from repro_torch.configs import ModelConfig

    return ModelConfig(**cell.family.port_config(cell.conf), use_pallas=use_pallas, remat="none")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", ["qwen2-0.5b.pd_ttft", "mamba2-370m.pd_ttft"])
def test_reference_agrees_with_the_port_in_float32(smoke_cell, name, use_pallas):
    from repro_torch.models import prefill_forward
    from repro_torch.serving import greedy_decode

    cell = smoke_cell(name)
    gen = torch.Generator().manual_seed(derived_seed(3, 1))
    params = cell.family.make_params(cell.conf, gen, torch.float32)
    cfg = _port(cell, params, use_pallas)
    S, n_new = 96, 4
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=gen)
    with torch.no_grad():
        logits, kv = prefill_forward(cfg, params, tokens)
        cache = harness.grow(cfg, kv, S + n_new)
        served = torch.as_tensor(greedy_decode(cfg, params, cache, logits, S, n_new))
        ref_logits, ref_shipped, ref_decoded = cell.family.forward(
            cell.conf, params, torch.cat([tokens, served[:, :-1].long()], 1), S)
    assert check.rel_err(logits, ref_logits[:, 0]) < 1e-5
    got_shipped, got_decoded = cell.family.program_caches(kv, cache, S, S + n_new - 1)
    assert check.cache_err(got_shipped, ref_shipped) < 1e-4
    assert check.cache_err(got_decoded, ref_decoded) < 1e-4
    for b in range(2):
        assert check.token_gap(ref_logits[b], served[b]) == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_low_precision_control_reads_far_above_the_program(smoke_cell, name):
    """At the smoke sizes the float8 control's cache numbers read at least
    three times the bf16 program's: the comparison separates them."""
    from tentbench.control import control_readings

    cell = smoke_cell(name)
    res = harness.run_cell(cell, 11, 0.3, False, "cpu", emit=lambda obj: None)
    ctl = control_readings(cell, 11, "cpu")
    for key in ("prefill_cache_err", "decode_cache_err"):
        assert ctl[key] >= 3 * res["checks"][key]["value"] > 0, (key, ctl, res["checks"])


def test_precision_rounds_to_float8():
    p = Precision("float8_e4m3")
    x = torch.linspace(-3, 3, 101)
    err = (p.q(x) - x).abs().max()
    assert 0 < err <= 3 * 2 ** -4
    assert Precision().q(x) is x
    with pytest.raises(ValueError):
        Precision("int4")


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cell_at_its_own_size(card, name):
    """On the card, at the cell's own size, on three seeds: the float8
    control reads above the cell's limit in at least one number."""
    from tentbench.control import control_readings

    cell = harness.load_cell(name)
    limits = cell.spec["limits"]
    for seed in (101, 102, 103):
        ctl = control_readings(cell, seed, card)
        assert any(ctl[k] > limits[k] for k in ("token_gap", "prefill_cache_err",
                                                  "decode_cache_err")), (seed, ctl)
