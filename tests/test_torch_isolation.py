"""The port stands alone: importing every `repro_torch` module pulls in
neither `jax` nor any module of the reference package `repro`, and its
entry points never fall back to the CPU on their own."""
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
import importlib, json, pathlib, sys
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
print(json.dumps({"n": len(mods), "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(PKG)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen["n"] >= 30  # every module of the package was imported
    assert seen["bad"] == [], f"repro_torch pulled in: {seen['bad']}"


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
