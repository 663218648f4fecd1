"""The port's expert-parallel MoE FFN (`moe_ffn_ep`) against the reference's,
on the CPU.

On a 1x1 mesh (a one-rank gloo group here, a one-device jax mesh in the
reference) the expert-parallel path is the sorted dispatch: the port's
equals its own `moe_ffn_sorted` bit for bit and the reference's
`moe_ffn_ep` within 1e-5 (the packages' sorted paths differ by the
rounding of their matrix products, about 1e-6 here). On a 2x2 ("data",
"model") mesh of four gloo processes, each data shard's tokens are routed
at the capacity of that shard: the output equals the reference's `moe_ffn_sorted` on each shard's
tokens within 1e-5, and lb_loss is the mean of the shards'. Without a mesh
`moe_ffn_ep` is `moe_ffn_sorted`.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import moe as ref_moe
from repro.sharding.ctx import activation_sharding as ref_activation_sharding
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.sharding.ctx import activation_sharding
from repro_torch.sharding.rules import placements

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-moe-235b-a22b", "dbrx-132b"]
TOL = dict(rtol=1e-5, atol=1e-5)
T = 64


def _inputs(cfg, seed):
    """x (T, D) and the expert parameters, float32, from a seeded generator."""
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": rng.standard_normal((D, E)) * 0.1,
         "w_gate": rng.standard_normal((E, D, F)) * 0.05,
         "w_up": rng.standard_normal((E, D, F)) * 0.05,
         "w_down": rng.standard_normal((E, F, D)) * 0.05}
    x = rng.standard_normal((T, D))
    return x.astype(np.float32), {n: a.astype(np.float32) for n, a in p.items()}


@pytest.fixture(scope="module")
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cf", [4.0, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_on_a_1x1_mesh_is_the_sorted_dispatch(one_rank_group, arch, cf):
    cfg = get_smoke_config(arch).with_(moe_capacity_factor=cf)
    ref_cfg = ref_smoke_config(arch).with_(moe_capacity_factor=cf)
    x, p = _inputs(cfg, seed=7)
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    sorted_out, sorted_aux = moe.moe_ffn_sorted(cfg, tp, torch.from_numpy(x))

    mesh = make_host_mesh("cpu")
    rep = placements((), mesh)
    moe.ep_calls = 0
    with torch.no_grad(), activation_sharding(mesh):
        dp = {n: DTensor.from_local(t, mesh, rep, run_check=False) for n, t in tp.items()}
        dx = DTensor.from_local(torch.from_numpy(x), mesh, placements(("data", None), mesh),
                                run_check=False)
        out, aux = moe.moe_ffn_ep(cfg, dp, dx)
    assert moe.ep_calls == 1
    assert torch.equal(out.full_tensor(), sorted_out)
    for name in ("lb_loss", "z_loss"):
        assert torch.equal(aux[name].full_tensor(), sorted_aux[name])
    assert int(aux["dropped"]) == 0

    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    with jmesh, ref_activation_sharding(jmesh):
        want, want_aux = jax.jit(lambda x: ref_moe.moe_ffn_ep(ref_cfg, jp, x))(jnp.asarray(x))
    np.testing.assert_allclose(out.full_tensor().numpy(), np.asarray(want), **TOL)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[name].full_tensor()), float(want_aux[name]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_without_a_mesh_is_sorted(arch):
    cfg = get_smoke_config(arch)
    x, p = _inputs(cfg, seed=3)
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    moe.ep_calls = 0
    got, got_aux = moe.moe_ffn_ep(cfg, tp, torch.from_numpy(x))
    want, want_aux = moe.moe_ffn_sorted(cfg, tp, torch.from_numpy(x))
    assert moe.ep_calls == 0
    assert torch.equal(got, want)
    assert {k: float(v) for k, v in got_aux.items()} == {k: float(v) for k, v in want_aux.items()}


def test_ep_under_a_mesh_takes_a_dtensor(one_rank_group):
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    x, p = _inputs(cfg, seed=3)
    with activation_sharding(make_host_mesh("cpu")), pytest.raises(TypeError, match="DTensor"):
        moe.moe_ffn_ep(cfg, {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x))


_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe
from repro_torch.sharding.ctx import activation_sharding
from repro_torch.sharding.rules import param_partition_specs, placements

rank, store, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    inp = np.load(data)
    cfg = get_smoke_config(str(inp["arch"])).with_(moe_capacity_factor=float(inp["cf"]))
    # the layer's leaves under the sharding rules: experts over model, D or
    # F over data, the router's D over data
    specs = param_partition_specs(cfg, mesh, {n: (1,) + inp[n].shape for n in moe.moe_param_shapes(cfg)})
    p = {n: distribute_tensor(torch.from_numpy(inp[n])[None], mesh, placements(specs[n], mesh))[0]
         for n in specs}
    x = distribute_tensor(torch.from_numpy(inp["x"]), mesh, placements(("data", None), mesh))
    with torch.no_grad(), activation_sharding(mesh):
        out, aux = moe.moe_ffn_ep(cfg, p, x)
    full = out.full_tensor()
    if rank == 0:
        np.savez(data + ".out.npz", out=full.numpy(), calls=moe.ep_calls,
                 lb=aux["lb_loss"].full_tensor().numpy(), zl=aux["z_loss"].full_tensor().numpy())
finally:
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("cf", [4.0, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_on_a_2x2_mesh_routes_each_data_shard(tmp_path, arch, cf):
    cfg = ref_smoke_config(arch).with_(moe_capacity_factor=cf)
    x, p = _inputs(cfg, seed=11)
    data = tmp_path / "inputs.npz"
    np.savez(data, x=x, arch=arch, cf=cf, **p)
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"),
                               str(data)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [proc.communicate(timeout=240)[0] for proc in procs]
    assert all(proc.returncode == 0 for proc in procs), "\n".join(logs)[-4000:]
    got = np.load(str(data) + ".out.npz")
    assert int(got["calls"]) == 1

    jp = {n: jnp.asarray(a) for n, a in p.items()}
    shards = [ref_moe.moe_ffn_sorted(cfg, jp, jnp.asarray(x[i * T // 2:(i + 1) * T // 2]))
              for i in range(2)]
    want = np.concatenate([np.asarray(out) for out, _ in shards])
    np.testing.assert_allclose(got["out"], want, **TOL)
    for key, name in (("lb", "lb_loss"), ("zl", "z_loss")):
        mean = np.mean([float(aux[name]) for _, aux in shards])
        np.testing.assert_allclose(float(got[key]), mean, **TOL)
