#!/usr/bin/env python3
"""The benchmark's command: one run of one cell of `BENCHMARK.json`.

    python3 tentbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs the port (`src/repro_torch`) beside it and as many CUDA cards as
the cell asks for; without them it exits with code 2 and prints no result.
Earlier stdout lines are JSON objects with an "info" key; the last is the
result. The numbers `correct` was decided by are the last lines of stderr
and the result's last key, "checks". Kernel and compiler caches stay under
`build/` in the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "nv_compute"}
_T0 = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started, from /proc; where /proc cannot
    say, since this module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "tentbench-cache" / sub)
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [p for p in sys.path[1:]]

    import torch

    from tentbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              process_age=process_age)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
