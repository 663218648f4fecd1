"""The port's MoE FFN against the reference's, on the CPU.

Routing, the sorted dispatch with its capacity drops, the dense oracle and
the combine's order. Inputs come from seeded numpy generators and go
through both packages' functions. Tolerances: 2e-3 in float32, 2e-2 in
bfloat16 (the reference's bar, tests/test_kernels.py:14-15); expert
indices and `dropped` exactly.
"""
import itertools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import moe as ref_moe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

F32 = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=2e-2, atol=2e-2)
TOL = {"float32": F32, "bfloat16": BF16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(arr, dtype="float32"):
    """One numpy array as the reference's and the port's input, in `dtype`."""
    a = arr.astype(np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(a), torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _expert_params(cfg, seed, dtype="float32", router_scale=0.1, expert_scale=0.05):
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes = {"router": (D, E), "w_gate": (E, D, F), "w_up": (E, D, F), "w_down": (E, F, D)}
    scale = {"router": router_scale}
    pairs = {n: _both(rng.standard_normal(s) * scale.get(n, expert_scale), dtype)
             for n, s in shapes.items()}
    return {n: p[0] for n, p in pairs.items()}, {n: p[1] for n, p in pairs.items()}


def _configs(arch, **kw):
    return ref_smoke_config(arch).with_(**kw), get_smoke_config(arch).with_(**kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
def test_route_matches_reference(arch, dtype):
    """Weights, picks, lb_loss and z_loss; routing runs in float32 also in
    a bf16 model, so the picks are equal in both types."""
    _, cfg = _configs(arch)
    rng = np.random.default_rng(1)
    x_ref, x = _both(rng.standard_normal((64, cfg.d_model)), dtype)
    r_ref, r = _both(rng.standard_normal((cfg.d_model, cfg.num_experts)) * 0.1, dtype)
    w_want, i_want, a_want = ref_moe.route(x_ref, r_ref, cfg.experts_per_token)
    w_got, i_got, a_got = moe.route(x, r, cfg.experts_per_token)
    assert w_got.dtype == torch.float32 and i_got.shape == (64, cfg.experts_per_token)
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(_np(w_got), _np(w_want), **F32)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(a_got[name]), float(a_want[name]), **F32)


def test_route_ties_pick_the_lower_expert_first():
    """Two pairs of experts with equal router columns: `jax.lax.top_k`
    returns the lower index first on a tie, at every k."""
    rng = np.random.default_rng(2)
    D, E, T = 8, 6, 5
    r = rng.standard_normal((D, E)).astype(np.float32)
    r[:, 2], r[:, 5] = r[:, 1], r[:, 3]
    x = rng.standard_normal((T, D)).astype(np.float32)
    for k in (2, 3, 4, 5):
        _, i_want, _ = ref_moe.route(jnp.asarray(x), jnp.asarray(r), k)
        weights, i_got, _ = moe.route(torch.from_numpy(x), torch.from_numpy(r), k)
        np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_want))
        tied = torch.isclose(weights[:, :-1], weights[:, 1:], rtol=0, atol=0)
        assert bool(tied.any()), "the constructed tie is not among the picks"


@pytest.mark.parametrize("arch,cf,T", [
    ("dbrx-132b", 4.0, 64),  # ample capacity: no drops (tests/test_models.py:81)
    ("qwen3-moe-235b-a22b", 1.0, 128),  # tight capacity (tests/test_models.py:96)
    ("qwen3-moe-235b-a22b", 1.25, 4),  # decode's T = B = 4: C = 2
    ("qwen3-moe-235b-a22b", 1.25, 2),  # T = 2: C = 1
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_matches_reference(arch, cf, T, dtype):
    ref_cfg, cfg = _configs(arch, moe_capacity_factor=cf)
    p_ref, p = _expert_params(cfg, seed=3, dtype=dtype, router_scale=1.0)
    x_ref, x = _both(np.random.default_rng(4).standard_normal((T, cfg.d_model)), dtype)
    want, a_want = ref_moe.moe_ffn_sorted(ref_cfg, p_ref, x_ref)
    got, a_got = moe.moe_ffn_sorted(cfg, p, x)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == x.shape
    assert int(a_got["dropped"]) == int(a_want["dropped"])
    if cf == 4.0:
        assert int(a_got["dropped"]) == 0
    if T <= 4:
        assert moe.capacity(cfg, T) == max(1, T // 2)
    if moe.capacity(cfg, T) == 1:
        assert int(a_got["dropped"]) > 0, "capacity 1 drops no pair here"
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(a_got[name]), float(a_want[name]), **F32)


def test_capacity_is_the_reference_arithmetic():
    """C = max(1, int(T * k / E * cf)), in that order of operations."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b").with_(num_experts=128, experts_per_token=8)
    assert moe.capacity(cfg, 4096) == 320
    assert moe.capacity(cfg, 4) == 1
    assert moe.capacity(cfg.with_(moe_capacity_factor=1.0), 128) == 8


def test_sorted_matches_dense_oracle():
    """Ample capacity: the sorted dispatch equals the oracle (the
    reference's own check, tests/test_models.py:79-93), and the oracle
    equals the reference's."""
    ref_cfg, cfg = _configs("dbrx-132b", moe_capacity_factor=4.0)
    p_ref, p = _expert_params(cfg, seed=5)
    x_ref, x = _both(np.random.default_rng(6).standard_normal((64, cfg.d_model)))
    y_sorted, a_sorted = moe.moe_ffn_sorted(cfg, p, x)
    y_dense, a_dense = moe.moe_ffn_dense(cfg, p, x)
    want, _ = ref_moe.moe_ffn_dense(ref_cfg, p_ref, x_ref)
    assert int(a_sorted["dropped"]) == 0
    np.testing.assert_allclose(y_sorted.numpy(), y_dense.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(a_sorted["lb_loss"]), float(a_dense["lb_loss"]), rtol=1e-5)
    np.testing.assert_allclose(y_dense.numpy(), _np(want), **F32)


def test_param_shapes_match_reference():
    for arch in ("qwen3-moe-235b-a22b", "dbrx-132b"):
        ref_cfg, cfg = _configs(arch)
        assert moe.moe_param_shapes(cfg) == ref_moe.moe_param_shapes(ref_cfg)


def test_sorted_is_bit_repeatable():
    """Two calls on the same inputs give the same bits (the combine uses
    no atomics, so this holds on the card too)."""
    _, cfg = _configs("qwen3-moe-235b-a22b")
    _, p = _expert_params(cfg, seed=7, router_scale=1.0)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (96, cfg.d_model)).astype(np.float32))
    a, _ = moe.moe_ffn_sorted(cfg, p, x)
    b, _ = moe.moe_ffn_sorted(cfg, p, x)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_adds_in_the_reference_scatter_order(dtype):
    """Rows whose sum depends on the order of the additions (1e8, 1, -1e8
    and their like): the combine equals the reference's scatter-add
    `zeros.at[tok].add(contrib)` bit for bit, and that is the
    expert-ascending order, not the order of the picks."""
    # every token picks experts 0, 1 and 2, in each of the six orders
    idx = np.array(list(itertools.permutations(range(3))))
    T, k = idx.shape
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    big = 1e8 if dtype == "float32" else 1e4  # big + 1 rounds to big
    values = np.array([big, 1.0, -big], np.float32)[flat[order]]
    contrib = np.stack([values, 2 * values], axis=1)  # (T*k, 2)
    tok = order // k
    c_ref, c = _both(contrib, dtype)
    want = jnp.zeros((T, 2), c_ref.dtype).at[jnp.asarray(tok)].add(c_ref)
    got = moe._combine(c, torch.from_numpy(order), T, k, TORCH_DTYPE[dtype])
    np.testing.assert_array_equal(_np(got), _np(want))
    # the same rows summed in the order of the picks differ somewhere
    places = np.empty_like(order)
    places[order] = np.arange(T * k)
    pick_order = np.zeros((T, 2), np.float32)
    for r in range(k):
        pick_order = pick_order + _np(c[torch.from_numpy(places.reshape(T, k)[:, r])])
    assert not np.array_equal(pick_order, _np(want))
