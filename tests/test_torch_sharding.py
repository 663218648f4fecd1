"""The port's sharding rules and activation constraints against the
reference's, on the CPU.

The reference's spec functions read only the mesh's axis sizes, so they run
on a `jax.sharding.AbstractMesh` without devices; the port's take the same
sizes as a mapping, or a `DeviceMesh` over a fake process group of 256 or
512 ranks (this process rank 0). Specs compare as tuples, the reference's
`PartitionSpec` being one. The reference's `repro.launch.dryrun` sets
XLA_FLAGS when imported: the `ref_dryrun` fixture brings jax's backend up
first and puts the variable back.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro import configs as ref_configs
from repro import models as ref_models
from repro.sharding import ctx as ref_ctx
from repro.sharding import rules as ref_rules
from repro_torch import configs, models
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import ctx, rules
from repro_torch.training.tree import named_leaves

ARCHS = [a.replace("_", "-") for a in configs.ARCH_IDS]
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# one rule per dim size class: divides both axes, divides model only, neither
CONSTRAIN_CASES = [
    ("bsd", (32, 128, 896)), ("bsf", (32, 128, 4864)), ("bsf", (1, 7, 24)),
    ("bshd", (32, 128, 64, 128)), ("bshd", (32, 128, 4, 128)), ("bshd", (2, 8, 14, 64)),
    ("bhst", (32, 64, 512, 4096)), ("logits", (32, 128, 151936)), ("logits", (128, 49152)),
    ("logits", (1, 1000)), ("ecd", (128, 40, 4096)), ("ecd", (4, 80, 256)),
    ("lbskd", (94, 128, 4096, 16, 128)), ("lbskd", (2, 1, 8, 1, 64)),
    # cache_kv: kv heads over model; granite's kv = 1 falls back to the length;
    # neither divides
    ("cache_kv", (128, 32768, 16, 128)), ("cache_kv", (128, 32768, 1, 128)),
    ("cache_kv", (1, 8192, 4, 128)), ("cache_kv", (2, 100, 1, 64)),
]


def _abstract(name):
    sizes = MESHES[name]
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _leaves(tree):
    return {k: tuple(v) for k, v in named_leaves(tree)}


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}


@pytest.fixture(scope="module")
def ref_dryrun():
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref

    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return ref


@pytest.fixture
def fake_group(request):
    """A fake default group of `request.param` ranks, destroyed after."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=request.param)
    try:
        yield request.param
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_reference(arch, mesh):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    got = rules.param_partition_specs(cfg, MESHES[mesh], models.param_shapes(cfg))
    want = ref_rules.param_partition_specs(ref_cfg, _abstract(mesh),
                                           ref_models.param_shapes(ref_cfg))
    assert _leaves(got) == _ref_leaves(want)
    assert _leaves(rules.opt_state_specs(got)) == _ref_leaves(ref_rules.opt_state_specs(want))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference_for_every_shape(arch, mesh):
    for shape in configs.INPUT_SHAPES.values():
        cfg = configs.config_for_shape(configs.get_config(arch), shape)
        ref_cfg = ref_configs.config_for_shape(ref_configs.get_config(arch), shape)
        B, S, enc = shape.global_batch, shape.seq_len, 1024 if cfg.is_encdec else 0
        got = rules.cache_partition_specs(cfg, MESHES[mesh], models.cache_shapes(cfg, B, S, enc))
        want = ref_rules.cache_partition_specs(ref_cfg, _abstract(mesh),
                                               ref_models.cache_shapes(ref_cfg, B, S, enc))
        assert got == {k: tuple(v) for k, v in want.items()}, shape.name


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_cache_shapes_equal_reference(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    got = {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."), t.device.type)
           for k, t in named_leaves(models.abstract_params(cfg))}
    flat = jax.tree_util.tree_flatten_with_path(ref_models.abstract_params(ref_cfg))[0]
    want = {"/".join(k.key for k in path): (tuple(s.shape), str(s.dtype), "meta")
            for path, s in flat}
    assert got == want
    enc = 1024 if cfg.is_encdec else 0
    got = {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."), t.device.type)
           for k, t in models.cache_shapes(cfg, 8, 2048, enc).items()}
    want = {k: (tuple(s.shape), str(s.dtype), "meta")
            for k, s in ref_models.cache_shapes(ref_cfg, 8, 2048, enc).items()}
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("B", [1, 2, 32, 128, 256, 48])
def test_batch_specs_equal_reference(ref_dryrun, mesh, B):
    assert rules.batch_spec(MESHES[mesh]) == tuple(ref_rules.batch_spec(_abstract(mesh)))
    assert dryrun._divisible_batch_spec(MESHES[mesh], B) == tuple(
        ref_dryrun._divisible_batch_spec(_abstract(mesh), B))


@pytest.mark.parametrize("fake_group", [256, 512], indirect=True)
def test_placements_on_the_production_mesh(fake_group):
    multi = fake_group == 512
    mesh = make_production_mesh(multi_pod=multi)
    assert rules.axis_sizes(mesh) == MESHES["2x16x16" if multi else "16x16"]
    off = 1 if multi else 0  # the pod dim leads
    rep = [Replicate()] * mesh.ndim
    assert rules.placements((), mesh) == tuple(rep)
    want = list(rep)
    want[off], want[off + 1] = Shard(1), Shard(2)
    assert rules.placements((None, "data", "model"), mesh) == tuple(want)
    want = list(rep)
    want[:off + 1] = [Shard(0)] * (off + 1)
    assert rules.placements(rules.batch_spec(mesh), mesh) == tuple(want)
    if multi:
        with pytest.raises(ValueError, match="order"):
            rules.placements((("data", "pod"),), mesh)
    # a spec's DTensor shards to the reference's shard shape
    spec = rules.param_partition_specs(configs.get_config("qwen3-moe-235b-a22b"), mesh,
                                       {"w_gate": (94, 128, 4096, 1536)})["w_gate"]
    local = torch.empty(rules.local_shape((94, 128, 4096, 1536), spec, mesh), device="meta")
    t = rules.shard_local(local, spec, mesh)
    assert tuple(t.shape) == (94, 128, 4096, 1536)
    assert tuple(t.to_local().shape) == (94, 8, 4096, 96)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind,shape", CONSTRAIN_CASES)
def test_constrain_rule_equals_reference(monkeypatch, mesh, kind, shape):
    """The spec the reference's `constrain` hands XLA, divisibility guard
    and cache_kv's fallback included, is the port's rule."""
    seen = []
    monkeypatch.setattr(ref_ctx, "_wsc", lambda x, spec: seen.append(tuple(spec)) or x)
    with ref_ctx.activation_sharding(_abstract(mesh)):
        ref_ctx.constrain(jax.ShapeDtypeStruct(shape, "float32"), kind)
    sizes = MESHES[mesh]
    batch = tuple(a for a in ("pod", "data") if a in sizes)
    state = {"sizes": sizes, "batch": batch if len(batch) > 1 else batch[0], "model": "model"}
    assert ctx.rule(kind, shape, state) == seen[0]


@pytest.mark.parametrize("fake_group", [256], indirect=True)
def test_constrain_redistributes_dtensors_only_under_a_context(fake_group):
    mesh = make_production_mesh()
    x = DTensor.from_local(torch.empty(2, 32, 1, 64, device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False)
    assert ctx.constrain(x, "cache_kv") is x  # no context: the identity
    plain = torch.zeros(3, 4)
    with ctx.activation_sharding(mesh):
        assert ctx.constrain(plain, "bsd") is plain
        y = ctx.constrain(x, "cache_kv")  # kv = 1: the length over model
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert tuple(y.to_local().shape) == (2, 2, 1, 64)
    with ctx.activation_sharding(mesh, enabled=False):
        assert ctx.constrain(x, "cache_kv") is x
    with pytest.raises(ValueError, match="unknown constraint kind"):
        ctx.rule("nope", (1,), {"sizes": {}, "batch": None, "model": None})


_SERVE_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.models import decode_step, init_params, prefill_forward
from repro_torch.sharding.ctx import activation_sharding
from repro_torch.sharding.rules import batch_spec, param_partition_specs, placements

rank, store, out, archs = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4:]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
errs = {}
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    split = lambda t, s: distribute_tensor(t, mesh, placements(s, mesh))
    rows = lambda t: split(t, batch_spec(mesh) + (None,) * (t.ndim - 1))
    tree = lambda f, t, s: ({k: tree(f, v, s[k]) for k, v in t.items()}
                            if isinstance(t, dict) else f(t, s))
    for arch in archs:
        cfg = get_smoke_config(arch).with_(use_pallas=True)
        gen = torch.Generator().manual_seed(0)
        params = init_params(cfg, gen, dtype=torch.float32, device="cpu")
        dparams = tree(split, params, param_partition_specs(cfg, mesh, params))
        tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
        enc = ({"enc_frames": torch.randn(4, 8, cfg.d_model, generator=gen)}
               if cfg.is_encdec else {})
        pad = lambda c: {n: F.pad(t, (0, 0, 0, 0, 0, 3)) if n in ("k", "v") else t.clone()
                         for n, t in c.items()}
        with torch.no_grad():
            want, want_cache = prefill_forward(cfg, params, tokens, **enc)
            with activation_sharding(mesh):
                got, cache = prefill_forward(cfg, dparams, rows(tokens),
                                             **{k: rows(v) for k, v in enc.items()})
            e = [(got.full_tensor() - want).abs().max().item()]
            e += [(cache[n].full_tensor() - want_cache[n]).abs().max().item() for n in cache]
            dcache = {n: distribute_tensor(t, mesh, cache[n].placements)
                      for n, t in pad({n: c.full_tensor() for n, c in cache.items()}).items()}
            layouts = {n: str(tuple(c.placements)) for n, c in dcache.items()}
            plain, tok = pad(want_cache), want.argmax(-1)[:, None]
            for i in range(3):
                w, plain = decode_step(cfg, params, plain, tok, 32 + i)
                with activation_sharding(mesh):
                    g, dcache = decode_step(cfg, dparams, dcache, rows(tok), 32 + i)
                e.append((g.full_tensor() - w).abs().max().item())
                tok = w.argmax(-1)[:, None]
            e += [(dcache[n].full_tensor() - plain[n]).abs().max().item() for n in plain]
        errs[arch] = (max(e), layouts)
    if rank == 0:
        import json
        open(out, "w").write(json.dumps(errs))
finally:
    dist.destroy_process_group()
"""


def test_sharded_serving_on_a_2x2_mesh_equals_unsharded(tmp_path):
    """Prefill and three decode steps of three smoke families on a 2x2
    ("data", "model") mesh of four gloo processes, against the unsharded
    entry points within 1e-5: granite's one kv head puts its cache's length
    over `model` (each rank scores its slots, the softmax is taken across
    them, a step writes into the shard that holds its slot); seamless adds
    the encoder and cross-attention; hymba the SSD scan and the sliding
    window's ring."""
    archs = ["granite-34b", "seamless-m4t-medium", "hymba-1.5b"]
    script = tmp_path / "rank.py"
    script.write_text(_SERVE_RANK)
    out = tmp_path / "errs.json"
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"),
                               str(out), *archs], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [proc.communicate(timeout=240)[0] for proc in procs]
    assert all(proc.returncode == 0 for proc in procs), "\n".join(logs)[-4000:]
    errs = json.loads(out.read_text())
    assert "Shard(dim=1)" in errs["granite-34b"][1]["k"]  # the length over model
    for arch in archs:
        assert errs[arch][0] <= 1e-5, (arch, errs[arch])


_TRAIN_RANK = """
import json
import sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params, loss_fn
from repro_torch.models import moe
from repro_torch.sharding.ctx import activation_sharding
from repro_torch.sharding.rules import batch_spec, param_partition_specs, placements
from repro_torch.training.tree import named_leaves

rank, store, out, archs = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4:]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
sorted_ffn = moe.moe_ffn_sorted


def per_data_shard(cfg, p, x):
    # the expert-parallel semantics without a mesh: each of the two data
    # shards' tokens routed at its own capacity, the aux losses averaged
    parts = [sorted_ffn(cfg, p, h) for h in x.chunk(2)]
    return torch.cat([o for o, _ in parts]), {
        n: sum(a[n] for _, a in parts) / 2 for n in ("lb_loss", "z_loss")}


res = {}
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    split = lambda t, s: distribute_tensor(t, mesh, placements(s, mesh))
    tree = lambda f, t, s: ({k: tree(f, v, s[k]) for k, v in t.items()}
                            if isinstance(t, dict) else f(t, s))
    for arch in archs:
        cfg = get_smoke_config(arch).with_(use_pallas=False)
        gen = torch.Generator().manual_seed(0)
        params = init_params(cfg, gen, dtype=torch.float32, device="cpu")
        specs = param_partition_specs(cfg, mesh, params)
        dparams = tree(lambda t, s: split(t.detach(), s).requires_grad_(), params, specs)
        params = tree(lambda t, s: t.detach().requires_grad_(), params, specs)
        batch = {n: torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)
                 for n in ("tokens", "targets")}
        moe.moe_ffn_sorted = per_data_shard  # through the backward's recomputation
        try:
            want, _ = loss_fn(cfg, params, batch)
            want.backward()
        finally:
            moe.moe_ffn_sorted = sorted_ffn
        moe.ep_calls = 0
        with activation_sharding(mesh):
            got, _ = loss_fn(cfg, dparams, {n: split(t, batch_spec(mesh) + (None,))
                                            for n, t in batch.items()})
            got.backward()
        errs = {"loss": abs(got.full_tensor().item() - want.item())}
        layouts = []
        for (name, p), (_, d) in zip(named_leaves(params), named_leaves(dparams), strict=True):
            errs[name] = (d.grad.full_tensor() - p.grad).abs().max().item()
            if tuple(d.grad.placements) != tuple(d.placements):
                layouts.append((name, str(d.grad.placements), str(d.placements)))
        res[arch] = {"errs": errs, "layouts": layouts, "ep_calls": moe.ep_calls,
                     "loss": want.item()}
    if rank == 0:
        open(out, "w").write(json.dumps(res))
finally:
    dist.destroy_process_group()
"""


def test_sharded_training_on_a_2x2_mesh_equals_unsharded(tmp_path):
    """`loss_fn` and its backward pass of the dense qwen2-0.5b and the MoE
    qwen3-moe smoke models on a 2x2 ("data", "model") mesh of four gloo
    processes: vocab-sharded cross-entropy, the vocab-parallel embedding,
    the constraints' gradients and `moe_ffn_ep` in both layers. The loss and
    every parameter's gradient equal the unsharded pass within 1e-5, and
    each gradient lies in its parameter's layout. The unsharded MoE routes
    each data shard's tokens at its own capacity and averages the aux
    losses, as expert parallelism defines them."""
    archs = ["qwen2-0.5b", "qwen3-moe-235b-a22b"]
    script = tmp_path / "rank.py"
    script.write_text(_TRAIN_RANK)
    out = tmp_path / "res.json"
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"),
                               str(out), *archs], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [proc.communicate(timeout=240)[0] for proc in procs]
    assert all(proc.returncode == 0 for proc in procs), "\n".join(logs)[-4000:]
    res = json.loads(out.read_text())
    # each layer's forward and its recomputation in the backward pass (remat)
    layers = configs.get_smoke_config("qwen3-moe-235b-a22b").num_layers
    assert res["qwen3-moe-235b-a22b"]["ep_calls"] == 2 * layers
    for arch in archs:
        assert res[arch]["layouts"] == [], (arch, res[arch]["layouts"])
        worst = max(res[arch]["errs"].items(), key=lambda kv: kv[1])
        assert worst[1] <= 1e-5, (arch, worst)
