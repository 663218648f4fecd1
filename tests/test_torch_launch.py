"""The port's launch layer on the CPU: the dry run's arithmetic against the
reference's, the dry run itself on meta tensors under fake process groups,
and the H100 roofline.

The reference's `repro.launch.dryrun` sets XLA_FLAGS when it is imported;
the `ref_dryrun` fixture brings jax's backend up first (so the flag changes
nothing here) and puts the variable back afterwards.
"""
import os

import jax
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.device_mesh import init_device_mesh

from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, roofline
from repro_torch.training.tree import named_leaves

ARCHS = [a.replace("_", "-") for a in configs.ARCH_IDS]
SIZES = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}
# the reference's numbers for the paper's model (its _analytic_bytes on an
# AbstractMesh): 16x16 and 2x16x16 bytes a device
QWEN3_MOE_BYTES = {"train_4k": (9_219_932_164, 9_219_932_164),
                   "prefill_32k": (1_843_986_432, 1_843_986_432),
                   "decode_32k": (4_998_103_040, 3_421_044_736),
                   "long_500k": (1_942_552_576, 1_942_552_576)}
SMOKE_RUNS = ["qwen2-0.5b", "mamba2-370m", "qwen3-moe-235b-a22b", "seamless-m4t-medium"]
KIND_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


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


def _abstract(multi):
    sizes = SIZES[multi]
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_bytes_and_model_flops_equal_reference(ref_dryrun, arch):
    """All 80 cases: 10 archs x 4 shapes x 2 meshes."""
    for shape in configs.INPUT_SHAPES:
        cfg = configs.config_for_shape(configs.get_config(arch), configs.INPUT_SHAPES[shape])
        ref_cfg = ref_configs.config_for_shape(ref_configs.get_config(arch),
                                               ref_configs.INPUT_SHAPES[shape])
        assert dryrun._model_flops(cfg, configs.INPUT_SHAPES[shape]) == ref_dryrun._model_flops(
            ref_cfg, ref_configs.INPUT_SHAPES[shape])
        for multi in (False, True):
            got = dryrun._analytic_bytes(arch, shape, SIZES[multi])
            assert got == ref_dryrun._analytic_bytes(arch, shape, _abstract(multi)), (shape, multi)
            if arch == "qwen3-moe-235b-a22b":
                assert got == QWEN3_MOE_BYTES[shape][multi]


@pytest.mark.parametrize("arch", ARCHS)
def test_every_sharded_dim_divides(arch):
    """The rules drop every axis that does not divide its dim, so no shard is
    padded (the reference's shard_shape would pad up)."""
    for shape in configs.INPUT_SHAPES:
        for multi in (False, True):
            sizes = SIZES[multi]
            spec = dryrun.input_specs(arch, shape, sizes)
            pairs = [(spec["params"], spec["pspecs"])]
            if "cache" in spec:
                pairs.append((spec["cache"], spec["cspecs"]))
            for tree, specs in pairs:
                for t, s in zip(named_leaves(tree), named_leaves(specs)):
                    for dim, axis in zip(t[1].shape, s[1]):
                        axes = axis if isinstance(axis, tuple) else (axis,) if axis else ()
                        n = 1
                        for a in axes:
                            n *= sizes[a]
                        assert dim % n == 0, (shape, t[0], s[1])


@pytest.mark.parametrize("shape", KIND_SHAPES)
@pytest.mark.parametrize("arch", SMOKE_RUNS)
def test_run_case_on_the_production_mesh(monkeypatch, ref_dryrun, arch, shape):
    """The smoke configs through every kind on the 16x16 mesh of a fake
    256-rank group: analytic bytes as the reference computes them, FLOPs,
    collectives and a roofline; no group is left behind."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(ref_dryrun, "get_config", ref_configs.get_smoke_config)
    rec = dryrun.run_case(arch, shape, multi_pod=False)
    assert not dist.is_initialized()
    assert rec["analytic_bytes_per_device"] == ref_dryrun._analytic_bytes(arch, shape,
                                                                          _abstract(False))
    cfg = get_smoke_config(arch)
    assert rec["loops"]["layers"] == cfg.num_layers
    assert ("encoder_layers" in rec["loops"]) == cfg.is_encdec
    assert rec["flops"] > 0 and rec["bytes"] > 0 and rec["collective_bytes"] > 0
    assert rec["dot_count"] > 0 and rec["fits_80GB"]
    assert rec["collectives"] and all(c["count"] > 0 for c in rec["collectives"].values())
    r = rec["roofline"]
    assert r["bottleneck"] == max(("compute", "memory", "collective"), key=lambda k: r[k + "_s"])
    assert rec["useful_ratio"] == r["useful_ratio"] > 0


def _prefill_flops(world, shape, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    with dryrun.fake_group(world):
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
        return dryrun.case_stats("qwen2-0.5b", "prefill_32k", mesh)[1]


def test_prefill_flops_split_over_the_mesh(monkeypatch):
    """qwen2-0.5b smoke, whose wide dims all divide 2: a rank of a 2x2 mesh
    does a quarter of the 1x1 mesh's FLOPs, so no redistribution left a
    product replicated."""
    one = _prefill_flops(1, (1, 1), monkeypatch)
    four = _prefill_flops(4, (2, 2), monkeypatch)
    assert four.flops * 4 == one.flops
    assert one.collective_bytes == 0 and four.collective_bytes > 0


def test_roofline_terms_and_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert roofline.HBM_BYTES == 80e9
    for flops, hbm, coll, want in ((989e12, 1e9, 1e6, "compute"), (1e9, 3.35e12, 1e6, "memory"),
                                   (1e9, 1e9, 50e9, "collective")):
        r = roofline.analyze_terms(flops=flops, hbm=hbm, coll=coll, chips=4, model_flops=flops)
        assert r.bottleneck == want
        assert r.useful_ratio == 0.25
    r = roofline.analyze_terms(flops=2 * 989e12, hbm=3.35e12, coll=25e9, chips=1, model_flops=1.0)
    assert (r.compute_s, r.memory_s, r.collective_s) == (2.0, 1.0, 0.5)
    assert roofline.analyze_terms(flops=0, hbm=0, coll=0, chips=1, model_flops=1).useful_ratio == 0


def test_main_reports_a_failed_case(monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setattr(dryrun, "run_case", boom)
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k"]) == 1
    assert "FAIL qwen2-0.5b x decode_32k x 16x16: RuntimeError: no such step" in \
        capsys.readouterr().out
