"""The port stands alone: importing every `repro_torch` module pulls in
neither `jax` nor any module of the reference package `repro`, and its
entry points never fall back to the CPU on their own. Importing it creates
no process group and sets no environment variable."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.device import default_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, json, os, pathlib, sys
env = dict(os.environ)
pkg = pathlib.Path(sys.argv[1])
mods = []
for p in sorted(pkg.rglob("*.py")):
    rel = p.relative_to(pkg.parent).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    mods.append(".".join(parts))
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
import torch.distributed as dist
print(json.dumps({"n": len(mods), "mods": mods, "bad": bad,
                  "group": dist.is_available() and dist.is_initialized(),
                  "env_changed": sorted(k for k in set(env) | set(os.environ)
                                        if env.get(k) != os.environ.get(k))}))
"""

# the modules that carry the engine's device paths and the observability
# tools; each must be among those imported without jax or the reference
ENGINE_MODULES = [
    "repro_torch.core.jit_core", "repro_torch.kernels.tent_core.kernel",
    "repro_torch.kernels.tent_core.ops", "repro_torch.kernels.tent_core.ref",
    "repro_torch.kernels.spray_sim.kernel", "repro_torch.kernels.spray_sim.ops",
    "repro_torch.kernels.spray_sim.ref", "repro_torch.scenarios.sweep",
    "repro_torch.obs.recorder", "repro_torch.obs.trace", "repro_torch.obs.explain",
]
# the training path: AdamW, the token stream, checkpoints and the loop
TRAINING_MODULES = [
    "repro_torch.training", "repro_torch.training.optimizer", "repro_torch.training.data",
    "repro_torch.training.checkpoint", "repro_torch.training.train_loop",
]
# sharding and launch: no process group and no environment variable at import
LAUNCH_MODULES = [
    "repro_torch.sharding.rules", "repro_torch.sharding.ctx", "repro_torch.launch.mesh",
    "repro_torch.launch.roofline", "repro_torch.launch.op_analysis", "repro_torch.launch.dryrun",
]

# tentlint: the linter reads the port's sources and imports none of them
ANALYSIS_MODULES = [
    "repro_torch.analysis.core", "repro_torch.analysis.rules", "repro_torch.analysis.lint",
    "repro_torch.analysis.baseline", "repro_torch.analysis.sanitize",
]


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(PKG)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen["n"] >= 30  # every module of the package was imported
    assert set(ENGINE_MODULES + TRAINING_MODULES + LAUNCH_MODULES
               + ANALYSIS_MODULES) <= set(seen["mods"])
    assert seen["bad"] == [], f"repro_torch pulled in: {seen['bad']}"
    assert seen["group"] is False, "importing the port created a process group"
    assert seen["env_changed"] == [], f"importing the port set {seen['env_changed']}"


def test_chip_smoke_imports_no_jax_and_no_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(names)


def test_default_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_device("cuda")
    assert default_device("cpu") == torch.device("cpu")
