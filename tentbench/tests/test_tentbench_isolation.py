"""Nothing of the benchmark imports JAX or the JAX package, the reference
imports nothing of the program, and a run without a card prints no result."""
import ast
import json
import os
import subprocess
import sys

from conftest import ROOT

from tentbench import harness

PKG = ROOT / "tentbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PKG / "reference").rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] in {"torch", "math", "__future__"}, (path, name)


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro_torch_lookalike" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "tentbench/run.py", "--workload", "qwen2-0.5b.pd_ttft",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    proc = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "correct" not in proc.stdout


def test_a_run_beside_no_program_exits_nonzero(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(PKG), str(tmp_path / "tentbench")], check=True)
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert not any(line.startswith("{") and "correct" in json.loads(line)
                   for line in proc.stdout.splitlines() if line.startswith("{"))
