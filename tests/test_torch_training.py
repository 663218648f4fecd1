"""The port's training modules against the reference's, on the CPU.

AdamW, the learning-rate schedule, the synthetic token stream, the
checkpoint table and its npz format, and three train steps of the smoke
qwen2-0.5b. Parameters come from the reference's `init_params` and cross
with `params_from_numpy`; batches come from the reference's
`SyntheticTokens`; everything else from seeded numpy generators.
Tolerances: AdamW's params within 1e-6 absolute and its moments within
1e-6 relative after one step; the schedule within 1e-7; train-step losses
within 1e-5 relative and params within 2 lr (an Adam step moves a weight by
about lr at most, so a tiny gradient whose sign differs between the
packages can move it the other way).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import training as ref_training
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import init_params as ref_init_params
from repro_torch import training
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import init_params, loss_fn, params_from_numpy, prefill_forward

SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 4)}, "e": (7, 2)}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _to_jax(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_public_names_are_the_references():
    assert sorted(training.__all__) == sorted(ref_training.__all__)
    assert len(training.__all__) == 13
    for name in training.__all__:
        assert callable(getattr(training, name))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-2, 10.0])
def test_adamw_update_matches_reference(dtype, grad_scale):
    """One step from moments already under way (step 3): params within 1e-6
    absolute, moments within 1e-6 relative, the pre-clip grad norm and the
    lr as the reference reports them. grad_scale 10 clips, 1e-2 does not."""
    rng = np.random.default_rng(0)
    params, grads = _tree(rng, SHAPES, 0.05), _tree(rng, SHAPES, grad_scale)
    m, v = _tree(rng, SHAPES, 0.01), jax.tree_util.tree_map(np.abs, _tree(rng, SHAPES, 0.01))
    cfg = training.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    ref_state = {"m": _to_jax(m, jnp.float32), "v": _to_jax(v, jnp.float32),
                 "step": jnp.int32(3)}
    want_p, want_s, want_aux = ref_training.adamw_update(
        cfg, _to_jax(params, getattr(jnp, dtype)), _to_jax(grads, getattr(jnp, dtype)), ref_state)
    tdt = getattr(torch, dtype)
    t_params = params_from_numpy(params, device="cpu", dtype=tdt)
    state = {"m": params_from_numpy(m, device="cpu"), "v": params_from_numpy(v, device="cpu"),
             "step": torch.tensor(3, dtype=torch.int32)}
    got_p, got_s, aux = training.adamw_update(
        cfg, t_params, params_from_numpy(grads, device="cpu", dtype=tdt), state)
    assert got_s["step"].dtype == torch.int32 and got_s["step"].shape == () and int(got_s["step"]) == 4
    for (name, got), (_, want) in zip(_leaves(got_p), _leaves(want_p)):
        assert got.dtype == tdt, name
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6, err_msg=name)
    for part in ("m", "v"):
        for (name, got), (_, want) in zip(_leaves(got_s[part]), _leaves(want_s[part])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0, err_msg=name)
    gnorm = np.sqrt(sum(float(np.sum(np.square(_np(g)))) for _, g in
                        _leaves(_to_jax(grads, getattr(jnp, dtype)))))
    np.testing.assert_allclose(float(aux["grad_norm"]), gnorm, rtol=1e-6)
    np.testing.assert_allclose(float(aux["grad_norm"]), float(want_aux["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(aux["lr"]), float(want_aux["lr"]), rtol=1e-7)
    if grad_scale > 1:
        assert float(aux["grad_norm"]) > cfg.grad_clip  # reported before the clip


def test_adamw_writes_in_place_from_a_fresh_state():
    """The params and moments the call returns are the tensors it was given,
    and the first step from `init_opt_state` matches the reference's."""
    rng = np.random.default_rng(1)
    params, grads = _tree(rng, SHAPES, 0.05), _tree(rng, SHAPES, 0.1)
    cfg = training.AdamWConfig(warmup_steps=1, total_steps=8)
    t_params = params_from_numpy(params, device="cpu")
    state = training.init_opt_state(t_params)
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32
    ids = [id(t) for _, t in _leaves(t_params)] + [id(t) for _, t in _leaves(state["m"])]
    got_p, got_s, _ = training.adamw_update(cfg, t_params, params_from_numpy(grads, device="cpu"),
                                            state)
    assert [id(t) for _, t in _leaves(got_p)] + [id(t) for _, t in _leaves(got_s["m"])] == ids
    ref_p = _to_jax(params, jnp.float32)
    want_p, _, _ = ref_training.adamw_update(cfg, ref_p, _to_jax(grads, jnp.float32),
                                             ref_training.init_opt_state(ref_p))
    for (name, got), (_, want) in zip(_leaves(got_p), _leaves(want_p)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("cfg", [training.AdamWConfig(),
                                 training.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110)])
@pytest.mark.parametrize("step", [0, 5, 10, 110])
def test_lr_schedule_matches_reference(cfg, step):
    got = training.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref_training.lr_schedule(cfg, jnp.int32(step))),
                               rtol=0, atol=1e-7)


def test_synthetic_tokens_are_the_references_bytes():
    dc = training.DataConfig(vocab_size=1000, seq_len=64, batch_size=2, seed=7)
    for shard in (0, 1):
        got = training.SyntheticTokens(dc, shard=shard, num_shards=2)
        want = ref_training.SyntheticTokens(
            ref_training.DataConfig(vocab_size=1000, seq_len=64, batch_size=2, seed=7),
            shard=shard, num_shards=2)
        for (step, g), w in zip(enumerate(got), want):
            if step == 3:
                break
            assert sorted(g) == sorted(w) == ["targets", "tokens"]
            for k in g:
                assert g[k].dtype == w[k].dtype == np.int32
                assert g[k].tobytes() == w[k].tobytes()


def _ref_state(arch="qwen2-0.5b", dtype=jnp.bfloat16):
    ref_params = ref_init_params(ref_smoke_config(arch), jax.random.PRNGKey(0), dtype=dtype)
    ref_opt = ref_training.init_opt_state(ref_params)
    # moments and step under way, so that the table's bytes are not all zeros
    rng = np.random.default_rng(2)
    ref_opt = {"m": jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), ref_opt["m"]),
        "v": ref_opt["v"], "step": jnp.int32(5)}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return ref_params, ref_opt, params_from_numpy(to_np(ref_params), device="cpu"), \
        params_from_numpy(to_np(ref_opt), device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "seamless-m4t-medium"])
def test_flatten_state_gives_the_references_keys_and_bytes(arch):
    ref_params, ref_opt, params, opt = _ref_state(arch)
    for tree, ref_tree, prefix in ((params, ref_params, "params/"), (opt, ref_opt, "opt/")):
        got = training.flatten_state(tree, prefix)
        want = ref_training.flatten_state(ref_tree, prefix)
        assert list(got) == list(want)
        for key in want:
            assert got[key].shape == want[key].shape, key
            assert got[key].tobytes() == np.ascontiguousarray(want[key]).tobytes(), key
            if want[key].dtype.name == "bfloat16":
                assert got[key].dtype == np.uint16, key
            else:
                assert got[key].dtype == want[key].dtype, key
    if arch == "seamless-m4t-medium":
        assert "params/encoder/layers/wq" in training.flatten_state(params, "params/")
    back = training.unflatten_like(params, training.flatten_state(params, "params/"), "params/")
    _assert_trees_bit_equal(back, params)


def _assert_trees_bit_equal(got, want):
    """Same keys, shapes, dtypes (bf16 as its bits) and bytes; each side a
    tree of tensors or of the reference's arrays."""
    def table(tree):
        return {k: training.flatten_state({"x": v})["x"] if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in _leaves(tree)}

    g, w = table(got), table(want)
    assert sorted(g) == sorted(w)
    for name in w:
        assert g[name].shape == w[name].shape, name
        assert g[name].tobytes() == np.ascontiguousarray(w[name]).tobytes(), name


def test_checkpoints_cross_between_the_packages(tmp_path):
    """An npz file written by either package loads in the other, bf16
    params and fp32 moments bit for bit, the step as an int32 scalar."""
    ref_params, ref_opt, params, opt = _ref_state()
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_training.save_checkpoint(ref_path, ref_params, ref_opt)
    training.save_checkpoint(port_path, params, opt)
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params/embed::dtype" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    got_p, got_o = training.load_checkpoint(ref_path, params, opt)
    _assert_trees_bit_equal(got_p, params)
    _assert_trees_bit_equal(got_o, opt)
    assert got_o["step"].dtype == torch.int32 and int(got_o["step"]) == 5
    assert got_p["embed"].dtype == torch.bfloat16
    want_p, want_o = ref_training.load_checkpoint(port_path, ref_params, ref_opt)
    _assert_trees_bit_equal(params, want_p)
    _assert_trees_bit_equal(opt, want_o)
    assert training.load_checkpoint(port_path, params)["embed"].dtype == torch.bfloat16


def test_unflatten_like_reinterprets_bits_and_checks_shapes():
    t = {"w": torch.tensor([1.5, -2.0, 3.0e-3], dtype=torch.bfloat16)}
    table = training.flatten_state(t)
    assert table["w"].dtype == np.uint16
    back = training.unflatten_like(t, table)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t["w"])
    with pytest.raises(ValueError, match="w"):
        training.unflatten_like({"w": torch.zeros(4, dtype=torch.bfloat16)}, table)


def _smoke_batches(cfg, n, B=2, S=32):
    data = ref_training.SyntheticTokens(ref_training.DataConfig(cfg.vocab_size, S, B, seed=0))
    return [data.example(i) for i in range(n)]


def test_three_train_steps_match_reference():
    """make_train_step for 3 steps on the smoke qwen2-0.5b in f32 from the
    same params and batches: losses within 1e-5 relative, params within
    2 lr of the reference's after each step."""
    ref_cfg = ref_smoke_config("qwen2-0.5b")
    cfg = get_smoke_config("qwen2-0.5b")
    opt_cfg = training.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    ref_step = jax.jit(ref_training.make_train_step(ref_cfg, opt_cfg))
    step_fn = training.make_train_step(cfg, opt_cfg)
    ref_opt, opt = ref_training.init_opt_state(ref_params), training.init_opt_state(params)
    for batch in _smoke_batches(cfg, 3):
        ref_params, ref_opt, want = ref_step(ref_params, ref_opt,
                                             {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, got = step_fn(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-4)
        lr = float(want["lr"])
        np.testing.assert_allclose(float(got["lr"]), lr, rtol=1e-7)
        for (name, g), (_, w) in zip(_leaves(params), _leaves(ref_params)):
            assert not g.requires_grad, name
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=2 * lr, err_msg=name)
    assert int(opt["step"]) == 3


def test_train_lowers_the_loss():
    """The reference's test_loss_decreases_smoke_model, on the port."""
    cfg = get_smoke_config("qwen2-0.5b")
    res = training.train(cfg, steps=12, batch_size=2, seq_len=64, log=lambda s: None,
                         device="cpu")
    assert res.steps == 12 and len(res.losses) == 12 and res.tokens_per_sec > 0
    assert np.all(np.isfinite(res.losses))
    assert np.mean(res.losses[-3:]) < np.mean(res.losses[:3]), res.losses


def test_train_encdec_takes_its_frames_from_a_seeded_generator():
    cfg = get_smoke_config("seamless-m4t-medium")
    runs = [training.train(cfg, steps=2, batch_size=2, seq_len=16, log=lambda s: None,
                           device="cpu").losses for _ in range(2)]
    assert runs[0] == runs[1] and np.all(np.isfinite(runs[0]))


def test_train_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        training.train(get_smoke_config("qwen2-0.5b"), steps=1, log=lambda s: None)


# ---------------------------------------------------------------- the repair
def _inputs(op, requires_grad, device):
    gen = torch.Generator().manual_seed(0)
    if op == "flash":  # q, k, v: (B, S, H or K, D)
        ts = [torch.randn(s, generator=gen) for s in ((1, 16, 4, 8), (1, 16, 2, 8), (1, 16, 2, 8))]
    else:  # x, a, B, C
        ts = [torch.randn((1, 16, 2, 4), generator=gen), -torch.rand((1, 16, 2), generator=gen),
              torch.randn((1, 16, 8), generator=gen), torch.randn((1, 16, 8), generator=gen)]
    return [t.to(device).requires_grad_(requires_grad and i == 0) for i, t in enumerate(ts)]


@pytest.mark.parametrize("op", ["flash", "ssd"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_wrappers_refuse_autograd(monkeypatch, op, device):
    """Under autograd the wrapper raises before it reaches its path: the
    plain version for CPU tensors, the kernel's binding for any other (meta
    tensors stand in for CUDA ones here, the binding recorded). Under
    torch.no_grad(), or without an input that requires grad, the same call
    reaches that path."""
    calls = []

    def record(*args, **kwargs):
        calls.append(args[0].device.type)
        out = torch.zeros_like(args[0])
        return (out, out) if op == "ssd" else out

    if op == "flash":
        fn = fa_ops.flash_attention
        monkeypatch.setattr(fa_ops, "flash_attention_ref", record)
        monkeypatch.setattr(fa_ops.kernel, "flash_attention_bshd", record)
    else:
        fn = ssd_ops.ssd_chunked
        monkeypatch.setattr(ssd_ops, "ssd_scan_ref", record)
        monkeypatch.setattr(ssd_ops, "kernel_scan", record)
    with pytest.raises(RuntimeError, match="no backward pass"):
        fn(*_inputs(op, True, device))
    assert calls == []
    with torch.no_grad():
        fn(*_inputs(op, True, device))
    fn(*_inputs(op, False, device))
    assert calls == [device, device]


def test_loss_and_training_refuse_the_kernels():
    cfg = get_smoke_config("qwen2-0.5b").with_(use_pallas=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                         device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="use_pallas"):
        loss_fn(cfg, params, {"tokens": tokens, "targets": tokens})
    with pytest.raises(ValueError, match="use_pallas"):
        training.make_train_step(cfg, training.AdamWConfig())
    with pytest.raises(ValueError, match="use_pallas"):
        training.train(cfg, steps=1, log=lambda s: None, device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_serving_prefill_with_the_kernels_runs_after_a_train_step(arch):
    """A kernel prefill (use_pallas=True; flash attention or the SSD scan)
    on the tensors a train step just updated runs, and agrees with the
    plain prefill: the step hands its params back without grad."""
    cfg = get_smoke_config(arch).with_(remat="none")
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                         device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _smoke_batches(cfg, 1)[0].items()}
    step_fn = training.make_train_step(cfg, training.AdamWConfig(warmup_steps=1, total_steps=2))
    params, _, metrics = step_fn(params, training.init_opt_state(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    kernel_logits, _ = prefill_forward(cfg.with_(use_pallas=True), params, batch["tokens"])
    plain_logits, _ = prefill_forward(cfg, params, batch["tokens"])
    np.testing.assert_allclose(_np(kernel_logits), _np(plain_logits), rtol=2e-3, atol=2e-3)
