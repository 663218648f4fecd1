"""The port's disaggregated server against the reference's, on the CPU.

Same parameters (the reference's smoke qwen2-0.5b, crossed with
`params_from_numpy`), same engine setup (`TentEngine(FabricSpec())`, as the
reference's own disagg test builds it). The KV byte count, metas and the
virtual transfer time must be exactly equal, and so must the greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import FabricSpec as RefFabricSpec
from repro.core import TentEngine as RefTentEngine
from repro.serving import disagg as ref_disagg
from repro_torch.configs import get_smoke_config
from repro_torch.core import FabricSpec, TentEngine
from repro_torch.models import params_from_numpy, prefill
from repro_torch.serving import (
    DisaggregatedServer,
    bytes_to_tree,
    monolithic_generate,
    tree_to_bytes,
)

ARCH = "qwen2-0.5b"
N_NEW, MAX_LEN = 6, 32


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_smoke_config(ARCH).with_(remat="none")
    cfg = get_smoke_config(ARCH).with_(remat="none")
    ref_params = ref_models.init_params(ref_cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 12), dtype=np.int32)
    return ref_cfg, ref_params, cfg, params, prompt


def _reference_step_logits(ref_cfg, ref_params, prompt):
    """The reference's logits at every greedy step (monolithic decode)."""
    logits, cache = ref_models.prefill(ref_cfg, ref_params, jnp.asarray(prompt), MAX_LEN)
    steps = [np.asarray(logits)]
    for i in range(N_NEW - 1):
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        logits, cache = ref_models.decode_step(
            ref_cfg, ref_params, cache, tok, jnp.int32(prompt.shape[1] + i))
        steps.append(np.asarray(logits))
    return steps


@pytest.mark.parametrize("async_handoff", [False, True])
def test_disagg_matches_reference(setup, async_handoff):
    ref_cfg, ref_params, cfg, params, prompt = setup
    # precondition: no near-tie in the reference's greedy choices, so equal
    # tokens are a fair demand on a float32 port
    for step in _reference_step_logits(ref_cfg, ref_params, prompt):
        top2 = np.sort(step, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > 1e-3), "near-tie: pick another prompt seed"

    ref_server = ref_disagg.DisaggregatedServer(RefTentEngine(RefFabricSpec()), ref_cfg, ref_params)
    want = ref_server.generate(jnp.asarray(prompt), n_new=N_NEW, max_len=MAX_LEN,
                               async_handoff=async_handoff)
    server = DisaggregatedServer(TentEngine(FabricSpec()), cfg, params)
    got = server.generate(torch.from_numpy(prompt), n_new=N_NEW, max_len=MAX_LEN,
                          async_handoff=async_handoff)
    assert got.kv_bytes == want.kv_bytes > 0
    assert got.kv_transfer_seconds == want.kv_transfer_seconds > 0
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens.dtype == want.tokens.dtype == np.int32

    mono = monolithic_generate(cfg, params, torch.from_numpy(prompt), N_NEW, MAX_LEN)
    np.testing.assert_array_equal(got.tokens, mono)


def test_cache_metas_match_reference(setup):
    ref_cfg, ref_params, cfg, params, prompt = setup
    _, ref_cache = ref_models.prefill(ref_cfg, ref_params, jnp.asarray(prompt), MAX_LEN)
    _, cache = prefill(cfg, params, torch.from_numpy(prompt), MAX_LEN)
    ref_data, ref_metas = ref_disagg.tree_to_bytes(ref_cache)
    data, metas = tree_to_bytes(cache)
    assert metas == ref_metas
    assert data.size == ref_data.size and data.dtype == ref_data.dtype == np.uint8


def _cache_arrays(seed):
    rng = np.random.default_rng(seed)
    return {"v": rng.standard_normal((2, 1, 8, 2, 16), dtype=np.float32),
            "k": rng.standard_normal((2, 1, 8, 2, 16), dtype=np.float32)}


def test_f32_byte_stream_equals_reference():
    arrays = _cache_arrays(12)
    ref_data, ref_metas = ref_disagg.tree_to_bytes({k: jnp.asarray(a) for k, a in arrays.items()})
    data, metas = tree_to_bytes({k: torch.from_numpy(a) for k, a in arrays.items()})
    assert metas == ref_metas == [((2, 1, 8, 2, 16), "float32")] * 2
    np.testing.assert_array_equal(data, ref_data)


def test_bf16_round_trip_keeps_bytes():
    arrays = _cache_arrays(13)
    tree = {k: torch.from_numpy(a).to(torch.bfloat16) for k, a in arrays.items()}
    data, metas = tree_to_bytes(tree)
    assert metas == [((2, 1, 8, 2, 16), "bfloat16")] * 2
    back = bytes_to_tree(data, tree)
    for key in tree:
        assert back[key].dtype == torch.bfloat16
        assert torch.equal(back[key].view(torch.int16), tree[key].view(torch.int16))
    np.testing.assert_array_equal(tree_to_bytes(back)[0], data)
    ref_data, ref_metas = ref_disagg.tree_to_bytes(
        {k: jnp.asarray(a, jnp.bfloat16) for k, a in arrays.items()})
    assert metas == ref_metas
    np.testing.assert_array_equal(data, ref_data)
