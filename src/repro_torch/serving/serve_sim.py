"""Multi-turn conversation serving simulator (paper §5.1.1 / Table 2).

Clients hold multi-turn conversations; every turn appends `input_tokens` new
prompt tokens to the history. Without HiCache the whole history re-prefills
each turn. With HiCache, the cached-prefix KV pages are *fetched* through
TENT (promotions from the global CPU/disk tiers are the latency-critical
elephant flows) and only the new suffix prefills. The transfer engine policy
("tent" vs "round_robin" vs others) is the only thing that changes between
the compared configurations — exactly the paper's ablation.

Three execution modes share one config and one stats schema:

* mode="sync" — the original analytical loop: per-slot bookkeeping on
  computed times, every promotion a blocking `engine.wait`. Kept as the
  parity reference and for the legacy Table-2 comparisons.
* mode="async" — the event-driven closed loop on the wave engine: each
  request is a small state machine (admit -> HiCache fetch -> chunked
  prefill -> optional prefill->decode KV handoff -> decode -> insert) whose
  transfers are asynchronous TENT batches with completion callbacks and
  whose compute runs on serial per-GPU resources, all on the fabric's
  virtual clock. Concurrent requests' elephant flows genuinely overlap and
  contend; chunked prefill interleaves with decode instead of blocking it;
  an optional `CheckpointEngine` refresh runs overlapped with live traffic.
* mode="batched" — the production-stream loop: 10^5-10^6 single-turn
  requests from a seeded Poisson/Zipf arrival stream
  (`repro_torch.scenarios.traffic`), advanced phase-at-a-time per virtual-clock
  tick over the struct-of-arrays `RequestTable` (mirroring what the engine's
  wave path does for slices) instead of one closure per request event. Each tick's
  admitted cohort promotes its cold prefix KV through ONE TENT batch
  (store -> GPU: the transfer-bound contention the spray policy decides),
  prefill and decode advance whole phases under vectorized token budgets,
  and latency percentiles stream through P^2 sketches so no per-request
  log is required.

Request state lives in `RequestTable` for async + batched modes (`Request`
is a thin per-row view, same pattern as `TelemetryStore`/`LinkTelemetry`);
the async event loop's outputs are unchanged by the storage swap.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import Location, MemoryKind, TentEngine
from ..obs import events as OBS
from .checkpoint_engine import CheckpointEngine
from .hicache import HiCache
from .perf_model import PerfModel
from ..analysis import hot_path
from .sketch import PercentileSketch

_EVENT_BUDGET = 60_000_000

# `log_requests=None` resolves to: keep the per-request log below this many
# total requests, drop it at or above (the log is O(N) memory and exists for
# completion-timeline plots; percentiles no longer need it).
LOG_AUTO_LIMIT = 10_000

# request lifecycle phases (RequestTable.phase values)
PH_PENDING = 0  # arrived / queued, no slot yet
PH_FETCH = 1  # waiting on the cohort's KV promotion transfer
PH_PREFILL = 2  # consuming the prefill token budget
PH_DECODE = 3  # consuming the decode token budget
PH_DONE = 4


@dataclasses.dataclass
class ServeSimConfig:
    clients: int = 12
    concurrency: int = 4
    turns: int = 10
    input_tokens: int = 2048
    output_tokens: int = 128
    seed: int = 0
    # --- closed-loop (mode="async") knobs ---
    mode: str = "sync"  # "sync" | "async"
    chunk_tokens: int = 0  # prefill chunk size; 0 = one monolithic chunk
    decode_chunk: int = 32  # decode tokens per compute item
    # prefill->decode KV handoff: > 0 ships history_tokens * this many bytes
    # from gpu_node to decode_node through TENT after every prefill
    handoff_bytes_per_token: int = 0
    gpu_node: int = 0
    decode_node: int = 1
    # overlapped weight refresh: this many CheckpointEngine.update_async
    # submissions spread evenly over the run (needs `checkpoint=` at init)
    checkpoint_updates: int = 0
    # keep the per-request (finish, bytes, ttft) log? None = auto: on below
    # LOG_AUTO_LIMIT total requests, off above (percentiles work either way)
    log_requests: Optional[bool] = None
    # --- production-stream (mode="batched") knobs ---
    # total single-turn requests in the stream; batched mode ignores
    # clients/turns and draws arrivals/groups from repro_torch.scenarios.traffic
    stream_requests: int = 0
    arrival_rate: float = 0.0  # mean arrivals/s (Poisson)
    zipf_alpha: float = 1.1  # popularity skew over prefix groups
    traffic_groups: int = 64  # distinct prefix groups
    prefix_frac: float = 0.5  # cached-prefix share of each prompt
    # KV bytes promoted per cold prefix token (store -> GPU elephant flows);
    # decoupled from the model's true KV width so scenarios can pin the
    # wire-contention level independently of the perf model
    stream_kv_bytes_per_token: int = 1024
    resident_s: float = 1.0  # GPU residency window per prefix group
    tick_s: float = 0.005  # virtual-clock tick of the batched stepper
    store_node: int = 1  # promotion source (KV store tier)

    def __post_init__(self) -> None:
        if self.mode not in ("sync", "async", "batched"):
            raise ValueError(f"unknown serving mode {self.mode!r}")
        if self.mode == "batched" and self.stream_requests <= 0:
            raise ValueError("mode='batched' needs stream_requests > 0")

    def total_requests(self) -> int:
        if self.mode == "batched":
            return self.stream_requests
        return self.clients * self.turns

    def keep_log(self) -> bool:
        if self.log_requests is not None:
            return self.log_requests
        return self.total_requests() < LOG_AUTO_LIMIT


@dataclasses.dataclass
class ServeStats:
    input_throughput: float  # input tokens / s
    avg_ttft: float
    p50_ttft: float
    p90_ttft: float
    p99_ttft: float
    round_avg_ttft: Dict[int, float]
    total_input_tokens: int
    makespan: float
    bytes_promoted: int
    # closed-loop extras (zeroed by the sync mode where not applicable)
    avg_tpot: float = 0.0
    p99_tpot: float = 0.0
    # sum of every request's un-overlapped service time (fetch + prefill +
    # handoff + decode): makespan strictly below this proves transfer/compute
    # overlap across concurrent requests
    serialized_seconds: float = 0.0
    bytes_handoff: int = 0
    checkpoint_updates: int = 0
    checkpoint_seconds: float = 0.0  # summed virtual update durations
    requests: int = 0  # completed requests (survives a dropped log)
    # (finish_time, bytes_moved, ttft) per request, admission order; empty
    # when ServeSimConfig.log_requests resolves off (percentiles above come
    # from the streaming sketches instead)
    request_log: List[Tuple[float, int, float]] = dataclasses.field(
        default_factory=list)


class _SerialResource:
    """One GPU's compute engine as a FIFO resource on the virtual clock:
    items run back to back in submission order, so a monolithic prefill
    monopolizes the GPU while chunked prefill lets other requests' decode
    items slot in between chunks — the continuous-batching contention the
    closed loop exists to expose."""

    def __init__(self, fabric):
        self.fabric = fabric
        self.busy_until = 0.0
        self.busy_seconds = 0.0

    def submit(self, duration: float, cb) -> None:
        start = max(self.fabric.now, self.busy_until)
        self.busy_until = start + duration
        self.busy_seconds += duration
        self.fabric.call_at(self.busy_until, cb)


# RequestTable columns: float64 timelines/budgets and int64 identities.
# `phase` is separate (int8) — it's the column the batched stepper selects on
# every tick, so it stays as compact as possible.
_REQ_F8 = ("arrival", "t_admit", "fetch_secs", "ttft", "decode_start",
           "finish", "service_secs", "t_mark", "prefill_left", "decode_left")
_REQ_I8 = ("client", "turn", "tenant", "input_tokens", "output_tokens",
           "prefix_bytes", "cached", "bytes_moved")


class RequestTable:
    """Struct-of-arrays request state: one contiguous numpy column per
    field, one row per request — the serving twin of `TelemetryStore`.
    The async closed loop reads/writes rows through `Request` views (thin,
    allocation-light); the batched production-stream stepper operates on
    whole columns per tick and never materializes a view."""

    __slots__ = ("capacity", "size", "phase") + _REQ_F8 + _REQ_I8

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.size = 0
        self.phase = np.zeros(capacity, dtype=np.int8)
        for f in _REQ_F8:
            setattr(self, f, np.zeros(capacity, dtype=np.float64))
        for f in _REQ_I8:
            setattr(self, f, np.zeros(capacity, dtype=np.int64))

    def create(self, client: int, turn: int) -> "Request":
        slot = self.size
        if slot >= self.capacity:
            raise IndexError("RequestTable capacity exhausted")
        self.size = slot + 1
        self.client[slot] = client
        self.turn[slot] = turn
        return Request(self, slot)


def _req_field(name: str, cast):
    def _get(self):
        return cast(getattr(self.table, name)[self.slot])

    def _set(self, value):
        getattr(self.table, name)[self.slot] = value

    return property(_get, _set)


class Request:
    """Thin per-row view over a `RequestTable` (the `LinkTelemetry`
    pattern): attribute access reads/writes the backing column, so view
    lifetime carries no state of its own."""

    __slots__ = ("table", "slot")

    def __init__(self, table: RequestTable, slot: int):
        self.table = table
        self.slot = slot


for _name in _REQ_F8:
    setattr(Request, _name, _req_field(_name, float))
for _name in _REQ_I8:
    setattr(Request, _name, _req_field(_name, int))
del _name


class _MetricsAccum:
    """Streaming request metrics: P^2 sketches for TTFT/TPOT percentiles
    (O(1) memory at any request count) plus the optional exact lists and
    per-request log. With `keep_log` on, percentile math uses the exact
    arrays — bit-identical to the pre-sketch behavior for every small
    scenario; with it off, the sketches answer alone."""

    __slots__ = ("keep_log", "ttft_sketch", "tpot_sketch", "ttfts", "tpots",
                 "request_log", "round_sum", "round_cnt", "serialized")

    def __init__(self, keep_log: bool):
        self.keep_log = keep_log
        self.ttft_sketch = PercentileSketch()
        self.tpot_sketch = PercentileSketch()
        self.ttfts: Optional[List[float]] = [] if keep_log else None
        self.tpots: Optional[List[float]] = [] if keep_log else None
        self.request_log: Optional[List[Tuple[float, int, float]]] = (
            [] if keep_log else None)
        self.round_sum: Dict[int, float] = {}
        self.round_cnt: Dict[int, int] = {}
        self.serialized = 0.0

    def observe(self, finish: float, bytes_moved: int, ttft: float,
                tpot: float, turn: int, service_secs: float) -> None:
        self.ttft_sketch.add(ttft)
        self.tpot_sketch.add(tpot)
        self.round_sum[turn] = self.round_sum.get(turn, 0.0) + ttft
        self.round_cnt[turn] = self.round_cnt.get(turn, 0) + 1
        self.serialized += service_secs
        if self.keep_log:
            self.ttfts.append(ttft)
            self.tpots.append(tpot)
            self.request_log.append((finish, bytes_moved, ttft))

    def stats(self, *, total_input: int, makespan: float,
              bytes_promoted: int, bytes_handoff: int = 0,
              ckpt_updates: int = 0, ckpt_seconds: float = 0.0) -> ServeStats:
        if self.keep_log and self.ttfts:
            arr = np.asarray(self.ttfts, dtype=float)
            tp = np.asarray(self.tpots, dtype=float)
            pct = {q: float(np.percentile(arr, q)) for q in (50, 90, 99)}
            avg_ttft = float(arr.mean())
            avg_tpot, p99_tpot = float(tp.mean()), float(np.percentile(tp, 99))
        else:
            ts, ps = self.ttft_sketch, self.tpot_sketch
            pct = {q: ts.percentile(q) for q in (50, 90, 99)}
            avg_ttft = ts.mean
            avg_tpot, p99_tpot = ps.mean, ps.percentile(99)
        return ServeStats(
            input_throughput=total_input / makespan if makespan > 0 else 0.0,
            avg_ttft=avg_ttft,
            p50_ttft=pct[50], p90_ttft=pct[90], p99_ttft=pct[99],
            round_avg_ttft={
                r: self.round_sum[r] / self.round_cnt[r]
                for r in self.round_sum if self.round_cnt[r]},
            total_input_tokens=total_input,
            makespan=makespan,
            bytes_promoted=bytes_promoted,
            avg_tpot=avg_tpot, p99_tpot=p99_tpot,
            serialized_seconds=self.serialized,
            bytes_handoff=bytes_handoff,
            checkpoint_updates=ckpt_updates,
            checkpoint_seconds=ckpt_seconds,
            requests=self.ttft_sketch.count,
            request_log=self.request_log or [],
        )


class ServingSimulator:
    def __init__(
        self,
        engine: TentEngine,
        perf: PerfModel,
        *,
        hicache: Optional[HiCache],
        sim_cfg: ServeSimConfig,
        checkpoint: Optional[CheckpointEngine] = None,
    ):
        self.engine = engine
        self.perf = perf
        self.hicache = hicache
        self.cfg = sim_cfg
        self.checkpoint = checkpoint

    def run(self) -> ServeStats:
        if self.cfg.mode == "batched":
            return self._run_batched()
        if self.cfg.clients <= 0 or self.cfg.turns <= 0:
            return self._stats([], {}, 0, 0.0, [], 0.0)
        if self.cfg.mode == "async":
            return self._run_async()
        return self._run_sync()

    # ------------------------------------------------------------- shared
    def _conversations(self) -> Dict[int, List[int]]:
        # one source of truth for workload shape: repro_torch.scenarios.traffic
        # (lazy import; scenarios packages import serving at executor level)
        from ..scenarios.traffic import conversation_tokens

        cfg = self.cfg
        return conversation_tokens(
            cfg.clients, cfg.turns, cfg.input_tokens, cfg.seed)

    def _stats(
        self,
        ttfts: List[float],
        per_round: Dict[int, List[float]],
        total_input: int,
        makespan: float,
        tpots: List[float],
        serialized: float,
        *,
        bytes_handoff: int = 0,
        ckpt_updates: int = 0,
        ckpt_seconds: float = 0.0,
        request_log: Optional[List[Tuple[float, int, float]]] = None,
    ) -> ServeStats:
        arr = np.asarray(ttfts, dtype=float)
        tp = np.asarray(tpots, dtype=float)
        return ServeStats(
            # guard: a zero-request run (clients=0) has zero makespan — the
            # throughput is 0, not a ZeroDivisionError
            input_throughput=total_input / makespan if makespan > 0 else 0.0,
            avg_ttft=float(arr.mean()) if arr.size else 0.0,
            p50_ttft=float(np.percentile(arr, 50)) if arr.size else 0.0,
            p90_ttft=float(np.percentile(arr, 90)) if arr.size else 0.0,
            p99_ttft=float(np.percentile(arr, 99)) if arr.size else 0.0,
            round_avg_ttft={r: float(np.mean(v)) for r, v in per_round.items() if v},
            total_input_tokens=total_input,
            makespan=makespan,
            bytes_promoted=self.hicache.bytes_promoted if self.hicache else 0,
            avg_tpot=float(tp.mean()) if tp.size else 0.0,
            p99_tpot=float(np.percentile(tp, 99)) if tp.size else 0.0,
            serialized_seconds=serialized,
            bytes_handoff=bytes_handoff,
            checkpoint_updates=ckpt_updates,
            checkpoint_seconds=ckpt_seconds,
            requests=len(ttfts),
            request_log=(request_log or []) if self.cfg.keep_log() else [],
        )

    # ------------------------------------------------------------- sync
    def _run_sync(self) -> ServeStats:
        cfg = self.cfg
        fabric = self.engine.fabric
        convo = self._conversations()
        ttfts: List[float] = []
        per_round: Dict[int, List[float]] = {r: [] for r in range(1, cfg.turns + 1)}
        request_log: List[Tuple[float, int, float]] = []
        slots = [0.0] * cfg.concurrency
        work = [(0.0, c, c, 1) for c in range(cfg.clients)]
        heapq.heapify(work)
        total_input = 0
        makespan = 0.0
        serialized = 0.0
        order = cfg.clients
        while work:
            ready, _, client, turn = heapq.heappop(work)
            si = int(np.argmin(slots))
            start = max(ready, slots[si])
            # the previous turn's fetch may have advanced the fabric past
            # `start`; the virtual clock is monotonic, so clamp the target
            fabric.run_until(max(start, fabric.now))
            history_tokens = convo[client][: turn * cfg.input_tokens]
            total_input += cfg.input_tokens
            if self.hicache is None:
                fetch_secs, cached, moved = 0.0, 0, 0
            else:
                res = self.hicache.fetch_prefix(history_tokens)
                fetch_secs, cached, moved = (
                    res.transfer_seconds, res.prefix_tokens, res.bytes_moved)
            new_tokens = len(history_tokens) - cached
            prefill_secs = self.perf.prefill_seconds(new_tokens)
            # server-side TTFT: from turn admission to first token (queue
            # wait excluded, matching the paper's serving-side measurement)
            ttft = fetch_secs + prefill_secs
            decode_secs = self.perf.decode_seconds(cfg.output_tokens)
            finish = start + fetch_secs + prefill_secs + decode_secs
            if self.hicache is not None:
                self.hicache.insert(history_tokens)
            ttfts.append(ttft)
            per_round[turn].append(ttft)
            request_log.append((finish, moved, ttft))
            serialized += fetch_secs + prefill_secs + decode_secs
            slots[si] = finish
            makespan = max(makespan, finish)
            if turn < cfg.turns:
                order += 1
                heapq.heappush(work, (finish, order, client, turn + 1))
        return self._stats(
            ttfts, per_round, total_input, makespan,
            [self.perf.tpot] * len(ttfts), serialized, request_log=request_log)

    # ------------------------------------------------------------- async
    def _run_async(self) -> ServeStats:
        cfg = self.cfg
        fabric = self.engine.fabric
        convo = self._conversations()
        t0 = fabric.now
        # flight recorder (repro_torch.obs): request phase spans ride the engine's
        # recorder; every site below is one `is not None` guard per phase
        rec = self.engine._rec
        ename = self.engine.name

        def mark_phase(req: Request, phase: str, span_t0: float,
                       **extra) -> None:
            payload = {"engine": ename, "client": req.client,
                       "turn": req.turn, "phase": phase, "t0": span_t0}
            payload.update(extra)
            rec.append(OBS.PHASE, fabric.now, payload)
        prefill_gpu = _SerialResource(fabric)
        decode_gpu = (
            _SerialResource(fabric) if cfg.handoff_bytes_per_token > 0
            else prefill_gpu)
        handoff_segs = None
        if cfg.handoff_bytes_per_token > 0:
            spec = self.engine.topology.spec
            max_kv = cfg.turns * cfg.input_tokens * cfg.handoff_bytes_per_token
            src = self.engine.register_segment(
                Location(node=cfg.gpu_node, kind=MemoryKind.DEVICE_HBM,
                         device=0, numa=spec.node.gpu_numa(0)),
                max_kv, name="pd-kv-src", materialize=False)
            dst = self.engine.register_segment(
                Location(node=cfg.decode_node, kind=MemoryKind.DEVICE_HBM,
                         device=0, numa=spec.node.gpu_numa(0)),
                max_kv, name="pd-kv-dst", materialize=False)
            handoff_segs = (src.segment_id, dst.segment_id)

        table = RequestTable(cfg.clients * cfg.turns)
        acc = _MetricsAccum(cfg.keep_log())
        state = {
            "outstanding": cfg.clients * cfg.turns,
            "pending_ops": 0,  # fire-and-forget inserts / checkpoint pulls
            "slots_free": cfg.concurrency,
            "total_input": 0,
            "last_finish": t0,
            "bytes_handoff": 0,
            "finished": 0,
            "ckpt_fired": 0,
            "ckpt_done": 0,
            "ckpt_seconds": 0.0,
        }
        queue: List[Tuple[float, int, int, int]] = []
        order = [cfg.clients]
        total_requests = cfg.clients * cfg.turns

        def enqueue(ready: float, client: int, turn: int) -> None:
            order[0] += 1
            heapq.heappush(queue, (ready, order[0], client, turn))
            fabric.call_at(ready, try_admit)

        def try_admit() -> None:
            while (state["slots_free"] > 0 and queue
                   and queue[0][0] <= fabric.now):
                _, _, client, turn = heapq.heappop(queue)
                state["slots_free"] -= 1
                start_request(table.create(client, turn))

        # -- stage 1: HiCache prefix fetch (async TENT batch) --------------
        def start_request(req: Request) -> None:
            req.t_admit = fabric.now
            state["total_input"] += cfg.input_tokens
            history = convo[req.client][: req.turn * cfg.input_tokens]
            if self.hicache is None:
                fetched(req, history, 0, 0.0, 0)
            else:
                self.hicache.fetch_prefix_async(
                    history,
                    lambda res, req=req, history=history: fetched(
                        req, history, res.prefix_tokens, res.transfer_seconds,
                        res.bytes_moved))

        # -- stage 2: chunked prefill on the (shared) compute resource ------
        def fetched(req: Request, history, cached, fetch_secs, moved) -> None:
            if rec is not None:
                mark_phase(req, "fetch", req.t_admit, bytes=moved)
            req.t_mark = fabric.now
            req.cached, req.fetch_secs, req.bytes_moved = cached, fetch_secs, moved
            req.service_secs = fetch_secs
            new_tokens = len(history) - cached
            chunk = cfg.chunk_tokens if cfg.chunk_tokens > 0 else max(new_tokens, 1)
            chunks = [chunk] * (new_tokens // chunk)
            if new_tokens % chunk:
                chunks.append(new_tokens % chunk)
            run_prefill(req, history, chunks)

        def run_prefill(req: Request, history, chunks: List[int]) -> None:
            if not chunks:
                prefilled(req, history)
                return
            secs = self.perf.prefill_seconds(chunks[0])
            req.service_secs += secs
            prefill_gpu.submit(
                secs, lambda req=req, history=history, rest=chunks[1:]:
                run_prefill(req, history, rest))

        # -- stage 3: prefill->decode KV handoff (async TENT batch) ---------
        def prefilled(req: Request, history) -> None:
            if rec is not None:
                mark_phase(req, "prefill", req.t_mark)
            if handoff_segs is None:
                req.ttft = fabric.now - req.t_admit
                start_decode(req, history)
                return
            nbytes = max(len(history) * cfg.handoff_bytes_per_token, 1)
            state["bytes_handoff"] += nbytes
            t_ship = fabric.now
            b = self.engine.allocate_batch()
            self.engine.submit_transfer(
                b, [(handoff_segs[0], 0, handoff_segs[1], 0, nbytes)])

            def shipped(res, req=req, history=history, t_ship=t_ship,
                        nbytes=nbytes):
                assert res.ok, res.error
                if rec is not None:
                    mark_phase(req, "handoff", t_ship, bytes=nbytes)
                req.service_secs += fabric.now - t_ship
                # PD mode: the first token comes from the decode worker, so
                # TTFT includes the KV handoff
                req.ttft = fabric.now - req.t_admit
                start_decode(req, history)

            self.engine.on_batch_done(b, shipped)

        # -- stage 4: decode in chunks on the decode resource ---------------
        def start_decode(req: Request, history) -> None:
            req.decode_start = fabric.now
            req.service_secs += self.perf.decode_seconds(cfg.output_tokens)
            run_decode(req, history, cfg.output_tokens)

        def run_decode(req: Request, history, tokens_left: int) -> None:
            if tokens_left <= 0:
                finish(req, history)
                return
            n = min(cfg.decode_chunk, tokens_left)
            decode_gpu.submit(
                self.perf.decode_seconds(n),
                lambda req=req, history=history, left=tokens_left - n:
                run_decode(req, history, left))

        # -- stage 5: finish, insert, release the slot ----------------------
        def finish(req: Request, history) -> None:
            now = fabric.now
            req.ttft = req.ttft or (now - req.t_admit)
            if rec is not None:
                mark_phase(req, "decode", req.decode_start)
                mark_phase(req, "request", req.t_admit, ttft=req.ttft)
            tpot = (now - req.decode_start) / max(cfg.output_tokens, 1)
            acc.observe(now, req.bytes_moved, req.ttft, tpot, req.turn,
                        req.service_secs)
            state["last_finish"] = max(state["last_finish"], now)
            state["outstanding"] -= 1
            state["finished"] += 1
            state["slots_free"] += 1
            if self.hicache is not None:
                state["pending_ops"] += 1

                def inserted(_secs):
                    state["pending_ops"] -= 1

                self.hicache.insert_async(history, inserted)
            maybe_refresh_weights()
            if req.turn < cfg.turns:
                enqueue(now, req.client, req.turn + 1)
            try_admit()

        # -- overlapped weight refresh --------------------------------------
        def maybe_refresh_weights() -> None:
            if self.checkpoint is None or cfg.checkpoint_updates <= 0:
                return
            due = (state["finished"] * (cfg.checkpoint_updates + 1)
                   ) // max(total_requests, 1)
            while state["ckpt_fired"] < min(due, cfg.checkpoint_updates):
                state["ckpt_fired"] += 1
                state["pending_ops"] += 1

                def refreshed(res):
                    state["ckpt_done"] += 1
                    state["ckpt_seconds"] += res.seconds
                    state["pending_ops"] -= 1

                self.checkpoint.update_async(refreshed)

        for c in range(cfg.clients):
            enqueue(t0, c, 1)
        try_admit()
        guard = 0
        while state["outstanding"] > 0 or state["pending_ops"] > 0:
            if not fabric.step():
                raise RuntimeError(
                    f"serving closed loop stalled: {state['outstanding']} "
                    f"requests and {state['pending_ops']} ops outstanding "
                    "with an idle fabric")
            guard += 1
            if guard > _EVENT_BUDGET:
                raise RuntimeError("serving closed loop exceeded event budget")
        return acc.stats(
            total_input=state["total_input"],
            makespan=state["last_finish"] - t0,
            bytes_promoted=self.hicache.bytes_promoted if self.hicache else 0,
            bytes_handoff=state["bytes_handoff"],
            ckpt_updates=state["ckpt_done"],
            ckpt_seconds=state["ckpt_seconds"],
        )

    # ------------------------------------------------------------- batched
    @hot_path
    def _run_batched(self) -> ServeStats:
        """Production-stream stepper: whole phases advance per tick over the
        SoA `RequestTable`; the only per-request Python work is the metric
        observation at finish. The spray policy decides the run through the
        per-tick cohort promotion batches — everything else is identical
        between policies, exactly the paper's ablation discipline."""
        from ..scenarios.traffic import TrafficSpec, promotion_bytes

        cfg = self.cfg
        fabric = self.engine.fabric
        t0 = fabric.now
        stream = TrafficSpec(
            requests=cfg.stream_requests, arrival_rate=cfg.arrival_rate,
            zipf_alpha=cfg.zipf_alpha, groups=cfg.traffic_groups,
            input_tokens=cfg.input_tokens, output_tokens=cfg.output_tokens,
            seed=cfg.seed).generate()
        promo = promotion_bytes(
            stream, prefix_frac=cfg.prefix_frac,
            kv_bytes_per_token=cfg.stream_kv_bytes_per_token,
            resident_s=cfg.resident_s)
        n = len(stream)

        tb = RequestTable(n)
        tb.size = n
        tb.arrival[:] = stream.arrival + t0
        tb.tenant[:] = stream.group
        tb.input_tokens[:] = stream.input_tokens
        tb.output_tokens[:] = stream.output_tokens
        tb.prefix_bytes[:] = promo
        phase = tb.phase  # PH_PENDING everywhere

        # promotion endpoints: the KV store tier's DRAM -> serving GPU HBM
        numa = self.engine.topology.spec.node.gpu_numa(0)
        src = self.engine.register_segment(
            Location(node=cfg.store_node, kind=MemoryKind.HOST_DRAM,
                     device=0, numa=0),
            max(int(promo.sum()), 1), name="stream-kv-store",
            materialize=False)
        dst = self.engine.register_segment(
            Location(node=cfg.gpu_node, kind=MemoryKind.DEVICE_HBM,
                     device=0, numa=numa),
            max(int(promo.sum()), 1), name="stream-kv-gpu",
            materialize=False)

        # vectorized compute budgets (tokens per tick)
        chunk = cfg.chunk_tokens if cfg.chunk_tokens > 0 else 256
        prefill_budget = cfg.tick_s * chunk / self.perf.prefill_seconds(chunk)
        decode_tokens = cfg.tick_s / self.perf.tpot  # per active request

        acc = _MetricsAccum(cfg.keep_log())
        state = {"bytes_promoted": 0, "in_flight": 0, "done": 0}
        admit_ptr = 0  # rows [0, admit_ptr) admitted; arrivals are sorted
        t = t0
        last_finish = t0
        total_input = 0
        # Livelock guard: a saturated server may legitimately run for many
        # multiples of the arrival span (prefill throughput bounds drain
        # rate), so cap *stalled* ticks — virtual time with zero completions
        # while work remains — rather than total runtime.
        stall_limit = int(120.0 / cfg.tick_s) + 1_000

        def cohort_done(res, rows=None):
            assert res.ok, res.error
            sel = rows[phase[rows] == PH_FETCH]
            phase[sel] = PH_PREFILL

        ticks = 0
        last_done = 0
        stalled = 0
        while state["done"] < n:
            t_next = t + cfg.tick_s
            fabric.run_until(t_next)

            # -- admission: arrival order, bounded by free slots ------------
            free = cfg.concurrency - state["in_flight"]
            if free > 0 and admit_ptr < n:
                hi = int(np.searchsorted(tb.arrival, t_next, side="right"))
                k = min(free, hi - admit_ptr)
                if k > 0:
                    rows = np.arange(admit_ptr, admit_ptr + k)
                    admit_ptr += k
                    state["in_flight"] += k
                    tb.t_admit[rows] = t_next
                    total_input += int(tb.input_tokens[rows].sum())
                    prefix_tok = np.rint(
                        tb.input_tokens[rows] * cfg.prefix_frac)
                    tb.prefill_left[rows] = tb.input_tokens[rows] - prefix_tok
                    tb.bytes_moved[rows] = tb.prefix_bytes[rows]
                    cold = tb.prefix_bytes[rows] > 0
                    phase[rows[~cold]] = PH_PREFILL
                    nbytes = int(tb.prefix_bytes[rows].sum())
                    if nbytes > 0:
                        phase[rows[cold]] = PH_FETCH
                        state["bytes_promoted"] += nbytes
                        b = self.engine.allocate_batch()
                        self.engine.submit_transfer(
                            b, [(src.segment_id, 0, dst.segment_id, 0,
                                 nbytes)])
                        self.engine.on_batch_done(
                            b,  # one closure per cohort batch, not per item
                            lambda res, rows=rows[cold]: cohort_done(  # tentlint: disable=hot-path-alloc
                                res, rows))

            # -- prefill: FIFO share of the tick's token budget -------------
            active = np.flatnonzero(phase == PH_PREFILL)
            if active.size:
                left = tb.prefill_left[active]
                cum = np.cumsum(left)
                nfull = int(np.searchsorted(cum, prefill_budget, side="right"))
                done_rows = active[:nfull]
                if nfull < active.size:
                    used = cum[nfull - 1] if nfull > 0 else 0.0
                    tb.prefill_left[active[nfull]] -= prefill_budget - used
                if done_rows.size:
                    tb.prefill_left[done_rows] = 0.0
                    tb.ttft[done_rows] = t_next - tb.t_admit[done_rows]
                    tb.decode_start[done_rows] = t_next
                    tb.decode_left[done_rows] = tb.output_tokens[done_rows]
                    phase[done_rows] = PH_DECODE

            # -- decode: every active request streams at the model's TPOT ---
            active = np.flatnonzero(phase == PH_DECODE)
            if active.size:
                tb.decode_left[active] -= decode_tokens
                fin = active[tb.decode_left[active] <= 0.0]
                if fin.size:
                    phase[fin] = PH_DONE
                    tb.finish[fin] = t_next
                    state["done"] += fin.size
                    state["in_flight"] -= fin.size
                    last_finish = t_next
                    tpots = (t_next - tb.decode_start[fin]) / np.maximum(
                        tb.output_tokens[fin], 1)
                    service = (t_next - tb.t_admit[fin])
                    for i, row in enumerate(fin):
                        acc.observe(
                            t_next, int(tb.bytes_moved[row]),
                            float(tb.ttft[row]), float(tpots[i]), 1,
                            float(service[i]))

            t = t_next
            ticks += 1
            if state["done"] > last_done:
                last_done = state["done"]
                stalled = 0
            else:
                stalled += 1
                if stalled > stall_limit:
                    # raise-path only: building the error message
                    hist = {p: int(np.sum(phase == p)) for p in  # tentlint: disable=hot-path-alloc
                            (PH_PENDING, PH_FETCH, PH_PREFILL, PH_DECODE)}
                    raise RuntimeError(
                        f"batched serving stream livelocked: "
                        f"{state['done']}/{n} finished, no completions in "
                        f"{stalled} ticks (pending/fetch/prefill/decode = "
                        f"{hist})")
        self._last_table = tb  # introspection hook for tests/benchmarks
        return acc.stats(
            total_input=total_input,
            makespan=last_finish - t0,
            bytes_promoted=state["bytes_promoted"],
        )
