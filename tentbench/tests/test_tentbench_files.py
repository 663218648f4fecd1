"""BENCHMARK.json against the benchmark's contract, and every file it names."""
import json
import re
import shutil
import statistics

import pytest
import torch
from conftest import CELLS, ROOT, smoke

from tentbench import harness
from tentbench.generator import Traffic

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"device_trace", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and int(BENCH["run_seconds"]) == BENCH["run_seconds"]
    assert BENCH["paths"] == ["tentbench"]
    cells = len(BENCH["workloads"])
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in E2E_SOURCES and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_and_reports_what_it_must(name):
    cell = harness.load_cell(name)
    assert "setup_s" in cell.e2e and len(cell.e2e) >= 2 and cell.per_layer
    for m in BENCH["per_layer"]:
        if m["name"] in cell.per_layer:
            assert m["moves"] in cell.e2e, (m["name"], name)
    for metric in cell.e2e + cell.per_layer:
        assert callable(harness.load_reader(cell.readers, metric))
    assert set(cell.spec["limits"]) == {"token_gap", "prefill_cache_err", "decode_cache_err",
                                        "shipped_differ"}
    assert cell.spec["limits"]["shipped_differ"] == 0


def test_every_file_is_used_and_every_config_has_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    metrics = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert {p.stem for p in (ROOT / "tentbench" / "metrics").glob("*.py")} == metrics
    assert {p.stem for p in (ROOT / "tentbench" / "workloads").glob("*.json")} == set(CELLS)
    assert {p.stem for p in (ROOT / "tentbench" / "traffic").glob("*.json")} == {
        w["traffic"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("name", sorted({w["traffic"] for w in BENCH["workloads"]}))
def test_traffic_is_the_same_multiset_for_every_seed(name):
    t = Traffic(json.loads((ROOT / "tentbench" / "traffic" / f"{name}.json").read_text()))
    for seed in (0, 1, 2**31 + 11, 2**33 + 5):
        blocks = t.blocks(seed)
        for _ in range(3):
            assert sorted(next(blocks)) == sorted(t.lengths)
    orders = {tuple(next(t.blocks(seed))) for seed in range(8)}
    assert len(orders) > 1 or len(set(t.lengths)) == 1


def test_pd_ttft_percentiles_fall_inside_one_length_class():
    """A window closes at the end of a block, so it holds whole copies of
    the multiset: P90 lands inside the second-longest class and P50 between
    the two middle ones, for any number of blocks from 3 on."""
    lengths = sorted(Traffic(json.loads((ROOT / "tentbench" / "traffic" /
                                         "pd_ttft.512-8192.json").read_text())).lengths)
    for k in range(3, 20):
        values = sorted(lengths * k)
        q = statistics.quantiles(values, n=100, method="inclusive")
        assert q[89] == lengths[-2] and lengths[7] <= q[49] <= lengths[8]


def test_a_cell_a_config_and_a_metric_are_added_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "tentbench", root / "tentbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "tentbench" / "configs" / "qwen2-0.5b.json").read_text())
    (root / "tentbench" / "configs" / "qwen2-0.5b-wide.json").write_text(
        json.dumps({**conf, "name": "qwen2-0.5b-wide"}))
    (root / "tentbench" / "traffic" / "pd_ttft.short.json").write_text(json.dumps(
        {"loop": "closed", "batch": 1, "prompt_lengths": [64, 128], "n_new": 2, "why": "short"}))
    limits = json.loads((ROOT / "tentbench" / "workloads" / "qwen2-0.5b.pd_ttft.json").read_text())
    (root / "tentbench" / "workloads" / "qwen2-0.5b-wide.short.json").write_text(json.dumps(limits))
    (root / "tentbench" / "metrics" / "pack_ms.ttft.py").write_text(
        "from tentbench.readers import span_mean_ms\n\n\n"
        "def read(run):\n    return span_mean_ms(run, 'pack')\n")
    bench["configs"].append({"name": "qwen2-0.5b-wide", "source": "x",
                             "file": "tentbench/configs/qwen2-0.5b-wide.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "qwen2-0.5b-wide.short", "config": "qwen2-0.5b-wide",
                               "traffic": "pd_ttft.short", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "qwen2-0.5b.pd_ttft" in m["workloads"]:
            m["workloads"].append("qwen2-0.5b-wide.short")
    bench["per_layer"].append({"name": "pack_ms.ttft", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "serving",
                               "moves": "ttft_p90_ms", "workloads": ["qwen2-0.5b-wide.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = smoke(harness.load_cell("qwen2-0.5b-wide.short", root))
    cell.traffic.lengths = [64, 128]
    assert "pack_ms.ttft" in cell.per_layer and "ttft_p90_ms" in cell.e2e
    lines = []
    res = harness.run_cell(cell, 7, 0.3, True, "cpu", emit=lines.append)
    assert res["correct"] and "pack_ms.ttft" in res["metrics"]
    # the spans come from an untraced window, the device trace from a second
    info = lines[0]
    assert info["trace"] == 1 and info["calls"] >= 1 and info["traced_window"]["calls"] >= 1
    assert list(res)[-1] == "checks"
    res = harness.run_cell(cell, 7, 0.3, False, "cpu", emit=lambda obj: None)
    assert set(res["metrics"]) == {"ttft_p90_ms", "ttft_p50_ms", "setup_s"}
    assert res["device"]["count"] == 1 and res["attempted"] >= 2 and res["failed"] == 0
    assert torch.get_default_dtype() == torch.float32
