"""The general harness: one run of one cell.

The timed window drives one PD-disaggregated call at a time through the
port's public serving functions, in this order:

  prefill   `models.prefill_forward` on the prefill worker (flash attention
            or the SSD scan), synchronised;
  pack      `serving.tree_to_bytes`: the cache as prefill produced it, to
            host bytes;
  engine    `DisaggregatedServer.ship_kv_async` on the run's one
            `TentEngine` (built as the `disagg_prefill_decode` scenario
            declares it, policy "tent"), rail (0, 1) failing from +2 ms to
            +20 ms virtual after submission, then `engine.run_until_idle()`;
  unpack    `serving.bytes_to_tree` onto the decode worker, which then grows
            K/V to the call's full length; the first token (the argmax of
            prefill's last logits) reaches the host: time to first token;
  decode    `serving.greedy_decode` through the shipped cache, n_new - 1
            steps.

Both workers are the one card; their nodes are the fabric's nodes 0 and 1.
Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by its name in `BENCHMARK.json`.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import resource
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import check
from .generator import Prompts, Traffic, derived_seed
from .reference.common import tf32_off
from .tracing import OpRanges, Profiler, Spans

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SCENARIO = "disagg_prefill_decode"
FLAP_RAIL, FLAP_AT, FLAP_UNTIL = (0, 1), 0.002, 0.020
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# streams of the seed's draws
WEIGHTS, PROMPTS, WARMUP_PROMPTS, SAMPLE = 1, 2, 3, 4
# tokens a warm-up call generates: every decode step has the same shapes
WARMUP_TOKENS = 3


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: dict  # configs/<config>.json
    traffic: Traffic  # traffic/<traffic>.json
    spec: dict  # workloads/<cell>.json: the sample and the limits of `correct`
    family: object  # reference/<family>.py
    e2e: List[str]
    per_layer: List[str]
    units: Dict[str, str]  # metric -> unit
    readers: Path  # the folder of the metric readers

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.conf["dtype"]]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    conf = _json(root / config["file"])
    e2e = [m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
    here = root / HERE.name
    return Cell(name=name, chips=int(w["chips"]), conf=conf,
                traffic=Traffic(_json(here / "traffic" / f"{w['traffic']}.json")),
                spec=_json(here / "workloads" / f"{name}.json"),
                family=importlib.import_module(f"tentbench.reference.{conf['reference']}"),
                e2e=e2e, per_layer=per_layer,
                units={m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]},
                readers=here / "metrics")


def load_reader(folder: Path, name: str) -> Callable:
    """`metrics/<name>.py`'s `read(run)`: the metric's value, or None where
    the run holds nothing for it to read."""
    spec = importlib.util.spec_from_file_location(f"tentbench_metric_{name}",
                                                  folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Call:
    batch: int
    prompt_len: int
    n_new: int
    ok: bool
    ttft_s: float = math.nan
    total_s: float = math.nan
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)
    kv_bytes: int = 0
    virtual_s: float = math.nan
    flap_overlapped: bool = False
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    prompt: Optional[torch.Tensor] = None  # (B, S)
    served: Optional[np.ndarray] = None  # (B, n_new)
    kept: Optional[tuple] = None  # (prefill cache, shipped cache, decode-written entries)


COUNTERS = ("waves", "slices_issued", "slices_retried", "completions_drained")


def grow(cfg, cache: dict, max_len: int) -> dict:
    """The decode worker's cache from the shipped one, in new tensors
    (decoding writes into its cache): K/V without a window grow to
    `max_len`; a window's ring and the SSM leaves are copied as they are."""
    pad = cfg.sliding_window == 0
    return {name: F.pad(t, (0, 0, 0, 0, 0, max_len - t.shape[2]))
            if pad and name in ("k", "v") else t.clone() for name, t in cache.items()}


class Program:
    """The system under test: the model's weights, one TENT engine for the
    whole run and the disaggregated server over it."""

    def __init__(self, cell: Cell, params: dict, device: torch.device):
        from repro_torch.configs import ModelConfig
        from repro_torch.core import TentEngine
        from repro_torch.scenarios import get
        from repro_torch.serving import DisaggregatedServer

        self.cell, self.params, self.device = cell, params, device
        self.cfg = ModelConfig(**cell.family.port_config(cell.conf), use_pallas=True, remat="none")
        spec = get(SCENARIO)
        self.engine = TentEngine(spec.topology.to_fabric_spec(),
                                 config=spec.engine.to_engine_config("tent"), seed=spec.seed)
        self.server = DisaggregatedServer(self.engine, self.cfg, params)
        self.flap_link = self.engine.topology.rdma_nic(*FLAP_RAIL).link_id

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, tokens: torch.Tensor, n_new: int, spans: Spans, keep: bool = False,
              served: Optional[int] = None) -> Call:
        """One call: prefill, handoff, decode to `n_new` positions, of which
        `served` (all by default) are generated; a warm-up call serves
        fewer, every shape of the call being the same."""
        from repro_torch.models import prefill_forward
        from repro_torch.serving import bytes_to_tree, greedy_decode, tree_to_bytes

        cfg, eng = self.cfg, self.engine
        B, S = tokens.shape
        call = Call(batch=B, prompt_len=S, n_new=n_new, ok=False, prompt=tokens)
        before = {c: getattr(eng, c) for c in COUNTERS}
        t0 = time.perf_counter()
        with spans("prefill"):
            logits, kv = prefill_forward(cfg, self.params, tokens)
            self.sync()
        with spans("pack"):
            data, _ = tree_to_bytes(kv)
        with spans("engine"):
            v0 = eng.fabric.now
            eng.fabric.schedule_failure(self.flap_link, at=v0 + FLAP_AT, recover_at=v0 + FLAP_UNTIL)
            done = {}
            dst, _ = self.server.ship_kv_async(data, lambda res: done.setdefault("res", res))
            eng.run_until_idle()
        res = done.get("res")
        call.spans = spans.seconds
        call.counters = {c: getattr(eng, c) - before[c] for c in COUNTERS}
        call.kv_bytes = int(data.size)
        if res is None or not res.ok:
            return call
        call.virtual_s = res.completed_at - res.submitted_at
        call.flap_overlapped = res.completed_at > v0 + FLAP_AT
        with spans("unpack"):
            shipped = bytes_to_tree(dst.read(0, data.size), kv)
            cache = grow(cfg, shipped, S + n_new)
            self.sync()
        logits.argmax(-1).cpu()  # the first token, on the host
        call.ttft_s = time.perf_counter() - t0
        with spans("decode"):
            call.served = greedy_decode(cfg, self.params, cache, logits, S, served or n_new)
        call.total_s = time.perf_counter() - t0
        call.ok = True
        if keep:
            got_shipped, decoded = self.cell.family.program_caches(shipped, cache, S, S + n_new - 1)
            call.kept = (kv, got_shipped, {k: v.clone() for k, v in decoded.items()})
        return call


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    calls: List[Call]  # the window's calls that completed
    window_s: float
    setup_s: float
    trace: Optional[object] = None  # tracing.Trace of a traced run
    op_calls: Optional[Dict[str, list]] = None  # shapes of each traced op call

    def flops(self, call: Call) -> float:
        return self.cell.family.flops(self.cell.conf, call.batch, call.prompt_len, call.n_new)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def kept(bi: int, j: int, block: List[int], cache_calls: int) -> bool:
    """Whether the window keeps call j of block bi for the cache comparison:
    the first `cache_calls` calls of the first block, and its longest."""
    return bi == 0 and (j < cache_calls or j == block.index(max(block)))


def pick(lengths: List[int], want: int, seed: int) -> List[int]:
    """`want` indices of `lengths` drawn from the seed, the longest first."""
    if not lengths or want <= 0:
        return []
    rng = np.random.default_rng(derived_seed(seed, SAMPLE))
    longest = max(range(len(lengths)), key=lambda i: lengths[i])
    others = [i for i in range(len(lengths)) if i != longest]
    return [longest] + [others[i] for i in rng.permutation(len(others))[:want - 1]]


def sample_rows(cell: Cell, calls: List[Call], seed: int) -> List[check.Row]:
    """Every row of the calls kept for the cache comparison, and `gap_rows`
    more drawn from the seed among the other finished rows."""
    rows, rest = [], []
    for ci, c in enumerate(calls):
        for b in range(c.batch):
            if c.kept is not None:
                rows.append(check.Row(c.prompt[b], c.served[b],
                                      *({k: v[:, b] for k, v in t.items()} for t in c.kept)))
            else:
                rest.append((ci, b))
    chosen = pick([calls[ci].prompt_len for ci, _ in rest], int(cell.spec["sample"]["gap_rows"]), seed)
    return rows + [check.Row(calls[ci].prompt[b], calls[ci].served[b])
                   for ci, b in (rest[i] for i in chosen)]


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"unread ({e.__class__.__name__})"


def host_rss_peak_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024  # KiB on Linux


def _summary(calls: List[Call]) -> dict:
    ok = [c for c in calls if c.ok]
    spans = {}
    for c in ok:
        for k, v in c.spans.items():
            spans[k] = spans.get(k, 0.0) + v
    n = max(1, len(ok))
    return {"calls": len(calls), "calls_ok": len(ok),
            "mean_call_ms": float(np.mean([c.total_s for c in ok])) * 1e3 if ok else None,
            "mean_span_ms": {k: v / n * 1e3 for k, v in spans.items()},
            "engine_per_call": {c: sum(x.counters.get(c, 0) for x in calls) / max(1, len(calls))
                                for c in COUNTERS},
            "kv_bytes_per_call": sum(c.kv_bytes for c in calls) / max(1, len(calls)),
            "virtual_s_mean": float(np.mean([c.virtual_s for c in ok])) if ok else None,
            "flap_overlapped": sum(c.flap_overlapped for c in ok)}


def window(prog: Program, traffic: Traffic, prompts: Prompts, seed: int, seconds: float,
           traced: bool, cache_calls: int) -> dict:
    """Calls in blocks until `seconds` have passed at a block's end: the
    calls, the window's length and each block's seconds. The first block's
    calls chosen by `kept` keep their caches."""
    calls: List[Call] = []
    block_s = []
    t0 = time.perf_counter()
    for bi, block in enumerate(traffic.blocks(seed)):
        b0 = time.perf_counter()
        for j, S in enumerate(block):
            calls.append(prog.serve(prompts.draw(traffic.batch, S), traffic.n_new, Spans(traced),
                                    keep=cache_calls > 0 and kept(bi, j, block, cache_calls)))
        block_s.append(time.perf_counter() - b0)
        if time.perf_counter() - t0 >= seconds:
            break
    prog.sync()
    return {"calls": calls, "window_s": time.perf_counter() - t0, "block_s": block_s}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             process_age: Callable[[], float] = lambda: 0.0,
             emit: Callable[[dict], None] = lambda obj: print(json.dumps(obj), flush=True)) -> dict:
    """One run: set-up, the window, the metrics, the comparison. A traced
    run follows the window with a second, traced one of the same length:
    the device-trace metrics read that, every other metric the first, so
    that the profiler's cost on the host shows in no span. Returns the
    result line's object; `emit` takes the earlier lines."""
    device = torch.device(device)
    tf32_off()
    stages = {"imports": process_age()}
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, WEIGHTS))
    stages["device"] = process_age()
    params = cell.family.make_params(cell.conf, gen, cell.dtype)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stages["weights"] = process_age()
    prog = Program(cell, params, device)
    stages["program_and_engine"] = process_age()
    traffic = cell.traffic
    vocab = int(cell.conf["vocab_size"])
    prompts = Prompts(seed, PROMPTS, vocab, device)
    warm = Prompts(seed, WARMUP_PROMPTS, vocab, device)
    for S in traffic.shapes():
        if not prog.serve(warm.draw(traffic.batch, S), traffic.n_new, Spans(False),
                          served=min(traffic.n_new, WARMUP_TOKENS)).ok:
            raise RuntimeError(f"a warm-up call of {S} tokens failed its KV handoff")
        stages.setdefault("first_warmup_call", process_age())
    prog.sync()
    setup_s = process_age()
    stages["warmup"] = setup_s
    win = window(prog, traffic, prompts, seed, seconds, False, int(cell.spec["sample"]["cache_calls"]))
    traced, tr, ops, prof = None, None, None, None
    if trace:
        # the profiler is first started here: once started, it leaves every
        # later kernel launch slower, which the first window must not see
        prof, ops = Profiler(device), OpRanges()
        try:
            prof.warm()
            prof.start()
            traced = window(prog, traffic, prompts, seed + 1, seconds, True, 0)
            tr = prof.stop(traced["window_s"])
        finally:
            ops.restore()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules loaded that the run may not load: {bad}")

    calls = win["calls"] + (traced["calls"] if traced else [])
    done = [c for c in win["calls"] if c.ok]
    run = Run(cell=cell, calls=done, window_s=win["window_s"], setup_s=setup_s, trace=tr,
              op_calls=ops.calls if ops else None)
    metrics = {}
    for name in (cell.per_layer if trace else cell.e2e):
        value = load_reader(cell.readers, name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": cell.units[name]}
    attempted = sum(c.batch for c in calls)
    failed = sum(c.batch for c in calls if not c.ok)
    info = {"info": "run", "cell": cell.name, "seed": seed, "trace": int(trace),
            "blocks": len(win["block_s"]), "requests": sum(c.batch for c in win["calls"]),
            "window_s": win["window_s"], "setup_s": setup_s, "setup_stages_s": stages,
            **_summary(win["calls"]), "host_rss_peak_bytes": host_rss_peak_bytes(),
            "card": nvidia_smi() if device.type == "cuda" else "none",
            "block_s": win["block_s"]}
    if traced is not None:
        info["traced_window"] = {"window_s": traced["window_s"], "block_s": traced["block_s"],
                                 **_summary(traced["calls"]), "profiler": tr.records}
    emit(info)

    # the comparison, once the program's state is freed
    rows = sample_rows(cell, done, seed)
    del prog, prof, calls, done, run, win, traced
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(cell.family, cell.conf, params, rows)
    ok, checks = check.verdict(numbers, cell.spec["limits"])
    emit({"info": "sample", "rows": len(rows), "cache_rows": sum(r.shipped is not None for r in rows),
          "served_tokens": int(sum(np.asarray(r.served).size for r in rows))})
    result = {"correct": bool(ok and failed == 0 and rows), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["checks"] = checks
    return result
