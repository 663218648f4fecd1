"""The benchmark's own tests: `python -m pytest tentbench/tests` from the
repository's root. They run on the CPU at the port's smoke sizes; a test
marked `chip` needs a CUDA card and skips, from inside the test, without
one."""
import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from tentbench import harness  # noqa: E402
from tentbench.generator import Traffic  # noqa: E402

# the port's SMOKE configurations (repro_torch/configs), in the files' keys
SMOKE = {
    "qwen2": {"num_hidden_layers": 2, "hidden_size": 224, "num_attention_heads": 4,
              "num_key_value_heads": 2, "intermediate_size": 448, "vocab_size": 1024},
    "mamba2": {"n_layer": 2, "d_model": 256, "vocab_size": 1024, "d_state": 32},
}
CELLS = ("qwen2-0.5b.pd_ttft", "mamba2-370m.pd_ttft", "mamba2-370m.decode_batch")


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


def smoke(cell: "harness.Cell") -> "harness.Cell":
    """The cell at the port's smoke sizes, with short prompts and few tokens."""
    cell = copy.copy(cell)
    cell.conf = {**cell.conf, **SMOKE[cell.conf["reference"]]}
    t = cell.traffic
    cell.traffic = Traffic({"loop": "closed", "batch": min(t.batch, 3),
                            "prompt_lengths": [64, 128, 192] if t.batch == 1 else [64],
                            "n_new": min(t.n_new, 5), "why": "smoke"})
    cell.spec = {**cell.spec, "sample": {"cache_calls": 2, "gap_rows": 3}}
    return cell


@pytest.fixture
def smoke_cell():
    return lambda name, root=ROOT: smoke(harness.load_cell(name, root))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
