"""A run on the CPU at the smoke sizes, past the harness's look for a card,
with the timed path broken underneath: `correct` comes out false for each
fault a cell can have, and true without one."""
import numpy as np
import pytest
import torch
from conftest import CELLS

from tentbench import harness


def _unchanged_state(monkeypatch):
    """A decode step that returns its cache as it found it."""
    import repro_torch.serving.disagg as disagg

    step = disagg.decode_step

    def decode_step(cfg, params, cache, token, pos):
        logits, _ = step(cfg, params, {k: v.clone() for k, v in cache.items()}, token, pos)
        return logits, cache

    monkeypatch.setattr(disagg, "decode_step", decode_step)


def _half_batch(monkeypatch):
    """Prefill computes the first half of the batch and hands its rows out
    for the rest."""
    import repro_torch.models as models

    prefill = models.prefill_forward

    def prefill_forward(cfg, params, tokens, **kw):
        half = max(1, tokens.shape[0] // 2)
        logits, kv = prefill(cfg, params, tokens[:half], **kw)
        idx = torch.arange(tokens.shape[0]) % half
        return logits[idx], {k: v[:, idx].contiguous() for k, v in kv.items()}

    monkeypatch.setattr(models, "prefill_forward", prefill_forward)


def _no_exchange(monkeypatch):
    """The KV handoff completes without moving the bytes."""
    from repro_torch.serving import DisaggregatedServer

    ship = DisaggregatedServer.ship_kv_async

    def ship_kv_async(self, data, on_done=None):
        return ship(self, np.zeros_like(data), on_done)

    monkeypatch.setattr(DisaggregatedServer, "ship_kv_async", ship_kv_async)


def _altered_token(monkeypatch):
    """The first token of every call's first row is changed where it is
    produced."""
    import repro_torch.serving as serving

    decode = serving.greedy_decode

    def greedy_decode(cfg, params, cache, last_logits, start, n_new):
        out = decode(cfg, params, cache, last_logits, start, n_new)
        out[0, 0] = (out[0, 0] + cfg.vocab_size // 2) % cfg.vocab_size
        return out

    monkeypatch.setattr(serving, "greedy_decode", greedy_decode)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "altered_token": _altered_token}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(smoke_cell, name):
    res = harness.run_cell(smoke_cell(name), 5, 0.3, False, "cpu", emit=lambda obj: None)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_the_run_incorrect(smoke_cell, monkeypatch, name, fault):
    cell = smoke_cell(name)
    if fault == "half_batch" and cell.traffic.batch == 1:
        pytest.skip("a batch of one has no half to leave out")
    FAULTS[fault](monkeypatch)
    res = harness.run_cell(cell, 5, 0.3, False, "cpu", emit=lambda obj: None)
    assert not res["correct"], res["checks"]
