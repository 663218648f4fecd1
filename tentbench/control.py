#!/usr/bin/env python3
"""The low-precision control of a cell's `correct`: the plain reference put
in the program's place and computed in float8 e4m3 (each product's operands
and each cache entry rounded, per-tensor scales), the step below the
configurations' bfloat16. It reads the cell's numbers on the prompts a run
of that seed would sample, with a continuation drawn from the seed in place
of served tokens (teacher forced): at each position, the gap of the token
the low precision puts first; the low-precision caches of the rows whose
caches a run keeps. The benchmark's own runs never run it.

    python3 tentbench/control.py --workload <cell> --seeds 11,12,13

One JSON line a seed. Needs a CUDA card, as the cell does.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTINUATION = 5  # the seed's stream of continuation tokens


def control_readings(cell, seed: int, device) -> dict:
    import torch

    from tentbench import check
    from tentbench.generator import Prompts, derived_seed
    from tentbench.harness import PROMPTS, WEIGHTS, kept, pick
    from tentbench.reference.common import Precision, tf32_off

    device = torch.device(device)
    tf32_off()
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, WEIGHTS))
    params = cell.family.make_params(cell.conf, gen, cell.dtype)
    vocab = int(cell.conf["vocab_size"])
    traffic = cell.traffic
    prompts = Prompts(seed, PROMPTS, vocab, device)
    cont = Prompts(seed, CONTINUATION, vocab, device)
    want = int(cell.spec["sample"]["gap_rows"])
    cache_calls = int(cell.spec["sample"]["cache_calls"])
    keep, rest = [], []
    for bi, block in enumerate(traffic.blocks(seed)):
        for j, S in enumerate(block):
            rows = prompts.draw(traffic.batch, S)
            (keep if kept(bi, j, block, cache_calls) else rest).extend(rows)
        if len(rest) >= 4 * want or bi >= 16:
            break
    chosen = [rest[i] for i in pick([r.numel() for r in rest], want, seed)]
    rows = [(p, cont.draw(1, traffic.n_new - 1)[0]) for p in keep + chosen]
    out = check.control(cell.family, cell.conf, params, rows, len(keep),
                        Precision("float8_e4m3"))
    return {"seed": seed, "rows": len(rows), "cache_rows": len(keep), **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + sys.path[1:]
    import torch

    from tentbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"cell": cell.name, **control_readings(cell, seed, "cuda")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
