"""Post-mortem explainer: per-slice causal chains and healing timelines.

Runs a named scenario with a flight recorder attached, then reconstructs —
from the trace alone — the story the aggregate report can't tell:

    PYTHONPATH=src python -m repro_torch.obs.explain \
        --scenario multi_engine_incast_flap --slice 12

prints slice 12's causal chain (intent -> wave pick with the per-candidate
score breakdown -> posts/failures/reroutes -> completion), and

    PYTHONPATH=src python -m repro_torch.obs.explain \
        --scenario lossy_gossip_flap --healing

prints the healing timeline (fault onset -> first failure -> last reroute ->
recovered) with the trace-derived heal time that the tests cross-check
against the runner's stall matrix. `--trace-out` additionally writes the
Perfetto/Chrome trace JSON.

`replay_wave` is the provenance core: it re-runs Algorithm 1
(`tent_choose_wave`, scheduler.py) on the pre-charge inputs snapshot the
recorder stored with each WAVE event, reproducing every per-candidate score
the engine computed — and asserts the replayed picks equal the recorded
ones, so the printed breakdowns are guaranteed to be the real decision, not
a reenactment that drifted.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.scheduler import tent_choose_wave
from . import events as EV
from .recorder import FlightRecorder
from .trace import export_chrome_trace, to_json

# mirror of ScenarioRunner.NEVER_RECOVERED_MS (scenarios/runner.py)
NEVER_RECOVERED_MS = 1e12


class ProvenanceError(AssertionError):
    """The replayed Algorithm 1 run disagreed with the recorded choices."""


def replay_wave(payload: dict) -> List[dict]:
    """Re-run Algorithm 1 over one recorded wave's pre-charge inputs.

    Returns one provenance dict per slice: the full per-candidate score
    vector at decision time, the gamma window, whether the all-excluded
    fallback fired, the chosen rail, and its post-charge queue. Performs
    the same IEEE-double operations in the same order as
    `repro_torch.core.scheduler.tent_choose_wave` and raises `ProvenanceError`
    if any replayed pick differs from the recorded one. The engine's own
    chooser, `tent_choose_wave`, is then run on the same inputs and must
    give the recorded picks too.
    """
    inp = payload["inputs"]
    q = [int(v) for v in np.asarray(inp["queued"])]
    gl = [float(v) for v in np.asarray(inp["glocal"], dtype=np.float64)]
    gr = [float(v) for v in np.asarray(inp["gremote"], dtype=np.float64)]
    bw = [float(v) for v in np.asarray(inp["bandwidth"], dtype=np.float64)]
    b0 = [float(v) for v in np.asarray(inp["beta0"], dtype=np.float64)]
    b1 = [float(v) for v in np.asarray(inp["beta1"], dtype=np.float64)]
    pen = [float(v) for v in np.asarray(inp["penalty"], dtype=np.float64)]
    exc = [bool(v) for v in np.asarray(inp["excluded"])]
    lens = [int(v) for v in np.asarray(payload["lengths"])]
    recorded = [int(v) for v in np.asarray(payload["choices"])]
    sids = list(payload["slices"])
    rr = int(inp["rr"])
    gamma = float(inp["gamma"])
    n_cands = len(q)
    inf = float("inf")
    one_plus_gamma = 1.0 + gamma
    rails = range(n_cands)

    def score(d: int, length: int) -> float:
        return pen[d] * (b0[d] + b1[d] * (((q[d] + gl[d]) + gr[d]) + length) / bw[d])

    out: List[dict] = []
    s: list = []
    cur_len = None
    infeasible_from = None
    for k in range(len(lens)):
        length = lens[k]
        if infeasible_from is not None:
            chosen = -1
            entry = {"slice": int(sids[k]), "length": length, "scores": None,
                     "fallback": False, "window": [], "chosen": -1,
                     "queued_after": None, "infeasible": True}
        else:
            if length != cur_len:
                cur_len = length
                s = [inf if exc[d] else score(d, length) for d in rails]
            s_min = min(s)
            if s_min == inf:
                fb = [pen[d] * (b0[d] + b1[d] * (q[d] + length) / bw[d])
                      for d in rails]
                fb_min = min(fb)
                if fb_min == inf:
                    infeasible_from = k
                    chosen = -1
                    entry = {"slice": int(sids[k]), "length": length,
                             "scores": list(fb), "fallback": True,
                             "window": [], "chosen": -1,
                             "queued_after": None, "infeasible": True}
                else:
                    window = [d for d in rails
                              if fb[d] <= one_plus_gamma * fb_min]
                    chosen = window[rr % len(window)]
                    rr += 1
                    q[chosen] += length
                    if not exc[chosen]:
                        s[chosen] = score(chosen, length)
                    entry = {"slice": int(sids[k]), "length": length,
                             "scores": list(fb), "fallback": True,
                             "window": window, "chosen": chosen,
                             "queued_after": q[chosen], "infeasible": False}
            else:
                threshold = one_plus_gamma * s_min
                scores_now = list(s)
                window = [d for d in rails if s[d] <= threshold]
                chosen = window[rr % len(window)]
                rr += 1
                q[chosen] += length
                s[chosen] = score(chosen, length)
                entry = {"slice": int(sids[k]), "length": length,
                         "scores": scores_now, "fallback": False,
                         "window": window, "chosen": chosen,
                         "queued_after": q[chosen], "infeasible": False}
        if chosen != recorded[k]:
            raise ProvenanceError(
                f"wave replay diverged at slice index {k} "
                f"(sid {sids[k]}): replayed rail {chosen}, "
                f"recorded {recorded[k]}")
        entry["link"] = (int(inp["local_links"][chosen])
                         if chosen >= 0 else -1)
        out.append(entry)
    picks = tent_choose_wave(
        inp["queued"], inp["glocal"], inp["gremote"], inp["bandwidth"],
        inp["beta0"], inp["beta1"], inp["penalty"], inp["excluded"],
        payload["lengths"], int(inp["rr"]), gamma)[0]
    if [int(v) for v in picks] != recorded:
        raise ProvenanceError(
            "tent_choose_wave on the recorded inputs does not give the "
            "recorded picks")
    return out


def slice_chain(recorder: FlightRecorder,
                events: Sequence[Tuple[float, int, dict]],
                sid: int) -> List[Tuple[float, str, dict]]:
    """Every event touching dense slice id `sid`, in virtual-clock order:
    the declaring intent, the wave that scheduled it (with its index within
    the wave), posts/failures/substitutions, and the drain that completed
    it."""
    if sid >= recorder.n_slices():
        raise ValueError(
            f"slice {sid} not in trace (have {recorder.n_slices()} slices)")
    bid, _, _ = recorder.slice_info(sid)
    steps: List[Tuple[float, str, dict]] = []
    for ts, kind, pl in events:
        if kind == EV.INTENT and pl["batch"] == bid:
            steps.append((ts, "intent", pl))
        elif kind == EV.WAVE and sid in pl["slices"]:
            k = list(pl["slices"]).index(sid)
            steps.append((ts, "wave", {"payload": pl, "index": k}))
        elif kind == EV.POST and pl["slice"] == sid:
            steps.append((ts, "reroute" if pl["attempt"] > 0 else "post", pl))
        elif kind == EV.FAIL and pl["slice"] == sid:
            steps.append((ts, "fail", pl))
        elif kind == EV.SUBSTITUTE and pl["slice"] == sid:
            steps.append((ts, "substitute", pl))
        elif kind == EV.COMPLETE and sid in pl["slices"]:
            i = list(pl["slices"]).index(sid)
            steps.append((ts, "complete",
                          {"link": int(pl["links"][i]),
                           "scheduled": float(pl["scheduled"][i]),
                           "t_pred": float(pl["t_pred"][i]),
                           "length": int(pl["lengths"][i])}))
        elif kind == EV.BATCH_DONE and pl["batch"] == bid:
            steps.append((ts, "batch_done", pl))
    return steps


def healing_timeline(events: Sequence[Tuple[float, int, dict]], *,
                     exclude_engines: Sequence[str] = ()) -> dict:
    """Reconstruct the healing story from the trace alone.

    Fault onsets are the LINK_FAIL firings; recovery per onset is the first
    application-batch completion at/after it, over batches from engines not
    in `exclude_engines` (cluster incast scenarios pass the contender engine
    here so the set of batches equals the workload completions the runner's
    stall matrix is computed from — the cross-check test asserts `heal_ms`
    equals `ScenarioReport.stall_ms` exactly). Also surfaces the paper's
    first-failure -> last-reroute -> recovered chain.
    """
    onsets = sorted({ts for ts, k, _ in events if k == EV.LINK_FAIL})
    done = sorted(ts for ts, k, pl in events
                  if k == EV.BATCH_DONE and pl["engine"] not in exclude_engines)
    fail_ts = [ts for ts, k, _ in events if k == EV.FAIL]
    reroute_ts = [ts for ts, k, pl in events
                  if k == EV.POST and pl["attempt"] > 0]
    done_arr = np.asarray(done)
    recoveries: List[Optional[float]] = []
    worst = 0.0
    never = False
    for onset in onsets:
        i = int(np.searchsorted(done_arr, onset))
        if i >= len(done):
            never = True
            recoveries.append(None)
            continue
        recoveries.append(done[i])
        # same accumulation as ScenarioRunner._stall_ms
        worst = max(worst, done[i] - onset)
    if not onsets:
        heal_ms = -1.0
    elif never:
        heal_ms = NEVER_RECOVERED_MS
    else:
        heal_ms = worst * 1e3
    first_failure = min(fail_ts + onsets) if (fail_ts or onsets) else None
    return {
        "onsets": onsets,
        "recoveries": recoveries,
        "heal_ms": heal_ms,
        "first_failure": first_failure,
        "last_reroute": max(reroute_ts) if reroute_ts else None,
        "n_failures": len(fail_ts),
        "n_reroutes": len(reroute_ts),
    }


# -- rendering ---------------------------------------------------------------

def _fmt_scores(entry: dict) -> str:
    if entry["scores"] is None:
        return "    (wave already infeasible; no scores computed)"
    rows = []
    for d, sc in enumerate(entry["scores"]):
        marks = []
        if d == entry["chosen"]:
            marks.append("<= chosen")
        elif d in entry["window"]:
            marks.append("in window")
        rows.append(f"    rail {d}: score {sc:.6e} {' '.join(marks)}".rstrip())
    if entry["fallback"]:
        rows.append("    (all rails excluded -> unmasked-cost fallback)")
    return "\n".join(rows)


def print_slice_chain(recorder: FlightRecorder, events, sid: int,
                      out=None) -> None:
    # resolve the stream at call time so stdout redirection/capture works
    out = out if out is not None else sys.stdout
    bid, off, length = recorder.slice_info(sid)
    print(f"slice {sid}: {length} B at offset {off} of batch {bid}",
          file=out)
    for ts, step, pl in slice_chain(recorder, events, sid):
        ms = ts * 1e3
        if step == "intent":
            print(f"  {ms:10.4f} ms  intent: batch {pl['batch']} declared "
                  f"({pl['transfers']} transfers, {pl['slices']} slices, "
                  f"{pl['bytes']} B)", file=out)
        elif step == "wave":
            prov = replay_wave(pl["payload"])
            entry = prov[pl["index"]]
            where = (f"rail {entry['chosen']} (link {entry['link']})"
                     if entry["chosen"] >= 0 else "infeasible")
            print(f"  {ms:10.4f} ms  wave pick "
                  f"(slice {pl['index'] + 1}/{len(prov)} of wave): {where}",
                  file=out)
            print(_fmt_scores(entry), file=out)
        elif step in ("post", "reroute"):
            print(f"  {ms:10.4f} ms  {step}: link {pl['link']} "
                  f"hop {pl['hop']} attempt {pl['attempt']} "
                  f"(predicted {pl['t_pred'] * 1e3:.4f} ms)", file=out)
        elif step == "fail":
            print(f"  {ms:10.4f} ms  FAIL on link {pl['link']} "
                  f"(attempt {pl['attempt']})", file=out)
        elif step == "substitute":
            print(f"  {ms:10.4f} ms  backend substituted "
                  f"(batch {pl['batch']})", file=out)
        elif step == "complete":
            print(f"  {ms:10.4f} ms  complete on link {pl['link']} "
                  f"(scheduled {pl['scheduled'] * 1e3:.4f} ms, "
                  f"predicted {pl['t_pred'] * 1e3:.4f} ms)", file=out)
        elif step == "batch_done":
            print(f"  {ms:10.4f} ms  batch {pl['batch']} done "
                  f"({pl['bytes']} B)", file=out)


def print_healing(h: dict, out=None) -> None:
    out = out if out is not None else sys.stdout
    if not h["onsets"]:
        print("no link failures in trace", file=out)
        return
    for onset, rec in zip(h["onsets"], h["recoveries"]):
        when = f"{rec * 1e3:.4f} ms" if rec is not None else "NEVER"
        print(f"  fault onset {onset * 1e3:.4f} ms -> recovered {when}",
              file=out)
    ff = h["first_failure"]
    lr = h["last_reroute"]
    print(f"  first failure event : "
          f"{ff * 1e3:.4f} ms" if ff is not None else
          "  first failure event : -", file=out)
    print(f"  last reroute posted : "
          f"{lr * 1e3:.4f} ms" if lr is not None else
          "  last reroute posted : -", file=out)
    print(f"  failures={h['n_failures']} reroutes={h['n_reroutes']}",
          file=out)
    verdict = "PASS" if h["heal_ms"] < 50.0 else "FAIL"
    print(f"  trace-derived heal time: {h['heal_ms']:.4f} ms "
          f"(sub-50 ms claim: {verdict})", file=out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.explain",
        description="Run a scenario with the flight recorder attached and "
                    "explain what happened from the trace.")
    ap.add_argument("--scenario", required=True,
                    help="named scenario from the library")
    ap.add_argument("--policy", default=None,
                    help="policy to run (default: the spec's primary)")
    ap.add_argument("--slice", type=int, default=None, metavar="SID",
                    help="print this dense slice id's causal chain")
    ap.add_argument("--healing", action="store_true",
                    help="print the healing timeline")
    ap.add_argument("--exclude-engines", default="cache", metavar="NAMES",
                    help="comma-separated engines whose batches don't count "
                         "as workload completions for --healing "
                         "(default: the incast contender)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the Perfetto/Chrome trace JSON here")
    ap.add_argument("--capacity", type=int, default=1 << 18,
                    help="flight-recorder ring capacity")
    args = ap.parse_args(argv)

    from ..scenarios import ScenarioRunner, get
    spec = get(args.scenario)
    policy = args.policy or spec.policies[0]
    rec = FlightRecorder(capacity=args.capacity)
    report = ScenarioRunner(spec).run_policy(policy, recorder=rec)
    events = list(rec.events())

    print(f"{spec.name} [{policy}]: {len(rec)} events retained "
          f"({rec.dropped} dropped), {rec.n_slices()} slices, "
          f"{rec.n_batches()} batches")
    counts = rec.counts()
    print("  " + "  ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    print(f"  throughput {report.throughput / 1e9:.3f} GB/s, "
          f"stall {report.stall_ms:.3f} ms")

    if args.slice is not None:
        print()
        print_slice_chain(rec, events, args.slice)
    if args.healing:
        print()
        excl = tuple(e for e in args.exclude_engines.split(",") if e)
        print_healing(healing_timeline(events, exclude_engines=excl))
    if args.trace_out:
        doc = export_chrome_trace(rec)
        with open(args.trace_out, "w") as f:
            f.write(to_json(doc))
        print(f"\ntrace written to {args.trace_out} "
              f"({len(doc['traceEvents'])} trace events)")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
