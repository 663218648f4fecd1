"""Chrome-trace / Perfetto JSON exporter for the flight recorder.

`export_chrome_trace` turns a `FlightRecorder` into the Trace Event Format
dict that both `chrome://tracing` and https://ui.perfetto.dev load directly;
`to_json` serializes it canonically (sorted keys, compact separators,
trailing newline) so that identical recordings produce byte-identical files
— the property the trace-determinism tests pin.

Layout: each engine is a Perfetto *process* (the fabric is pid 1; engines
get pids in first-appearance order), and event categories are fixed
*threads* within it:

    tid 1  slices     completed slice spans (scheduled -> drained)
    tid 2  scheduler  wave picks, scalar posts/reroutes, substitutions
    tid 3  batches    declared intents, application batch done/fail
    tid 4  control    exclusions, readmissions, link faults, gossip, churn
    tid 5  serving    request phase spans (admit/fetch/prefill/handoff/decode)

Virtual-clock seconds become trace microseconds (x 1e6). Spans are "X"
complete events; point events are "i" instants (thread scope); a final "C"
counter sample carries a metrics collection when one is supplied.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from . import events as EV

_TID_SLICES = 1
_TID_SCHED = 2
_TID_BATCH = 3
_TID_CONTROL = 4
_TID_SERVING = 5

_TID_NAMES = {
    _TID_SLICES: "slices",
    _TID_SCHED: "scheduler",
    _TID_BATCH: "batches",
    _TID_CONTROL: "control",
    _TID_SERVING: "serving",
}

_FABRIC_PID = 1


def export_chrome_trace(recorder, metrics: Optional[Dict[str, float]] = None
                        ) -> dict:
    """Build a Trace Event Format document from a recorder's events."""
    pids: Dict[str, int] = {"fabric": _FABRIC_PID}

    def pid_for(name: str) -> int:
        p = pids.get(name)
        if p is None:
            p = pids[name] = len(pids) + 1
        return p

    body: List[dict] = []
    last_us = 0.0
    n_events = 0
    for ts, kind, pl in recorder.events():
        n_events += 1
        us = float(ts) * 1e6
        if us > last_us:
            last_us = us
        if kind == EV.COMPLETE:
            pid = pid_for(pl["engine"])
            for sid, link, sched, ln in zip(pl["slices"], pl["links"],
                                            pl["scheduled"], pl["lengths"]):
                t0 = float(sched) * 1e6
                body.append({"ph": "X", "pid": pid, "tid": _TID_SLICES,
                             "ts": t0, "dur": max(us - t0, 0.0),
                             "name": f"slice {int(sid)}", "cat": "slice",
                             "args": {"link": int(link), "bytes": int(ln)}})
        elif kind == EV.WAVE:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_SCHED, us,
                                 f"wave n={len(pl['slices'])}", "wave",
                                 {"slices": len(pl["slices"]),
                                  "rr": int(pl["inputs"]["rr"])}))
        elif kind == EV.POST:
            pid = pid_for(pl["engine"])
            name = "reroute" if pl["attempt"] > 0 else "post"
            body.append(_instant(pid, _TID_SCHED, us, name, "post",
                                 {"slice": int(pl["slice"]),
                                  "link": int(pl["link"]),
                                  "hop": int(pl["hop"]),
                                  "attempt": int(pl["attempt"])}))
        elif kind == EV.FAIL:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_SCHED, us, "slice-fail", "fail",
                                 {"slice": int(pl["slice"]),
                                  "link": int(pl["link"]),
                                  "attempt": int(pl["attempt"])}))
        elif kind == EV.SUBSTITUTE:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_SCHED, us, "substitute-backend",
                                 "substitute",
                                 {"slice": int(pl["slice"]),
                                  "batch": int(pl["batch"])}))
        elif kind == EV.INTENT:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_BATCH, us,
                                 f"intent batch {int(pl['batch'])}", "intent",
                                 {"batch": int(pl["batch"]),
                                  "transfers": int(pl["transfers"]),
                                  "slices": int(pl["slices"]),
                                  "bytes": int(pl["bytes"])}))
        elif kind == EV.BATCH_DONE:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_BATCH, us,
                                 f"batch {int(pl['batch'])} done",
                                 "batch_done",
                                 {"batch": int(pl["batch"]),
                                  "bytes": int(pl["bytes"])}))
        elif kind == EV.BATCH_FAIL:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_BATCH, us,
                                 f"batch {int(pl['batch'])} FAILED",
                                 "batch_fail",
                                 {"batch": int(pl["batch"]),
                                  "error": str(pl["error"])}))
        elif kind == EV.EXCLUDE:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_CONTROL, us,
                                 f"exclude link {int(pl['link'])}", "health",
                                 {"link": int(pl["link"]),
                                  "explicit": bool(pl["explicit"])}))
        elif kind == EV.READMIT:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_CONTROL, us,
                                 f"readmit link {int(pl['link'])}", "health",
                                 {"link": int(pl["link"]),
                                  "verified": bool(pl["verified"])}))
        elif kind == EV.LINK_FAIL:
            body.append(_instant(_FABRIC_PID, _TID_CONTROL, us,
                                 f"link {int(pl['link'])} FAIL", "fault",
                                 {"link": int(pl["link"]),
                                  "until": float(pl["until"])}))
        elif kind == EV.DEGRADE:
            body.append(_instant(_FABRIC_PID, _TID_CONTROL, us,
                                 f"link {int(pl['link'])} degrade", "fault",
                                 {"link": int(pl["link"]),
                                  "until": float(pl["until"]),
                                  "factor": float(pl["factor"])}))
        elif kind == EV.RUMOR_SENT:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_CONTROL, us, "rumor-send",
                                 "gossip",
                                 {"link": int(pl["link"]),
                                  "version": int(pl["version"]),
                                  "exclude": bool(pl["exclude"]),
                                  "peers": int(pl["peers"])}))
        elif kind == EV.RUMOR_RECV:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_CONTROL, us, "rumor-apply",
                                 "gossip",
                                 {"link": int(pl["link"]),
                                  "version": int(pl["version"]),
                                  "exclude": bool(pl["exclude"])}))
        elif kind == EV.ANTI_ENTROPY:
            body.append(_instant(_FABRIC_PID, _TID_CONTROL, us,
                                 "anti-entropy", "gossip",
                                 {"members": int(pl["members"])}))
        elif kind == EV.ENGINE_JOIN:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_CONTROL, us, "join", "churn", {}))
        elif kind == EV.ENGINE_LEAVE:
            pid = pid_for(pl["engine"])
            body.append(_instant(pid, _TID_CONTROL, us, "leave", "churn", {}))
        elif kind == EV.PHASE:
            pid = pid_for(pl["engine"])
            t0 = float(pl["t0"]) * 1e6
            args = {"client": int(pl["client"]), "turn": int(pl["turn"])}
            if "bytes" in pl:
                args["bytes"] = int(pl["bytes"])
            if "ttft" in pl:
                args["ttft_ms"] = float(pl["ttft"]) * 1e3
            body.append({"ph": "X", "pid": pid, "tid": _TID_SERVING,
                         "ts": t0, "dur": max(us - t0, 0.0),
                         "name": str(pl["phase"]), "cat": "serving",
                         "args": args})

    meta: List[dict] = []
    for name, pid in sorted(pids.items(), key=lambda kv: kv[1]):
        meta.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                     "args": {"name": name}})
        for tid, tname in _TID_NAMES.items():
            meta.append({"ph": "M", "pid": pid, "tid": tid,
                         "name": "thread_name", "args": {"name": tname}})

    if metrics:
        body.append({"ph": "C", "pid": _FABRIC_PID, "tid": 0, "ts": last_us,
                     "name": "metrics",
                     "args": {k: float(v) for k, v in metrics.items()}})

    return {
        "displayTimeUnit": "ms",
        "traceEvents": meta + body,
        "otherData": {
            # the schema's name, shared with the reference package, so the
            # two packages' traces of one run are byte-identical
            "generator": "repro.obs",
            "events": n_events,
            "dropped": int(recorder.dropped),
        },
    }


def _instant(pid: int, tid: int, us: float, name: str, cat: str,
             args: dict) -> dict:
    return {"ph": "i", "s": "t", "pid": pid, "tid": tid, "ts": us,
            "name": name, "cat": cat, "args": args}


def to_json(doc: dict) -> str:
    """Canonical serialization: identical docs -> identical bytes."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"


def validate_trace(doc: dict) -> List[str]:
    """Check Trace Event Format invariants Perfetto relies on. Returns a
    list of problems (empty = loadable)."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "i", "C", "M"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        for field in ("pid", "tid", "name"):
            if field not in ev:
                problems.append(f"event {i} ({ph}): missing {field!r}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"event {i} ({ph}): bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} (X): bad dur {dur!r}")
        if ph == "i" and ev.get("s") not in ("t", "p", "g"):
            problems.append(f"event {i} (i): bad scope {ev.get('s')!r}")
        args = ev.get("args", {})
        if not isinstance(args, dict):
            problems.append(f"event {i}: args not a dict")
        else:
            for k, v in args.items():
                if not isinstance(v, (int, float, str, bool)):
                    problems.append(
                        f"event {i}: args[{k!r}] has non-JSON-scalar "
                        f"type {type(v).__name__}")
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as exc:  # pragma: no cover
        problems.append(f"document not JSON-serializable: {exc}")
    return problems
