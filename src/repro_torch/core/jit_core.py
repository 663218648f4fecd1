"""The engine's fused cores on the card (`EngineConfig.jit_core` + Monte Carlo).

Two layers share this module:

1. `EngineJitCore` — the engine-side adapter behind `EngineConfig.jit_core`.
   It routes the two telemetry-array kernels of the closed loop — the wave
   chooser (`TentPolicy.choose_wave`) and the batched completion drain
   (`TelemetryStore.on_complete_many`) — through fixed-shape fp64 CUDA
   kernels (`repro_torch.kernels.tent_core`: `tent_choose_wave_padded`,
   `tent_on_complete_many`). Arrays are padded to power-of-two buckets, as
   the reference pads them for its jitted programs, and results are
   bit-identical to the numpy path. The scalar/wave Python path stays in
   charge of everything stateful — staged hops, retries, substitutions, app
   callbacks — exactly as before; the adapter only replaces the arithmetic
   inside two already-batched call sites, selected per-batch by an
   online-tuned crossover that mirrors the `WAVE_MIN` tuner. On the CPU
   (`device="cpu"`) the same calls run the kernels' plain torch versions.

2. `SprayProgram` / `spray_sweep` — a fully fused model of the spray
   closed loop for Monte Carlo fault sweeps: wave-choose -> busy-chain
   post -> fault check (+ one masked retry) -> completion-ordered EWMA
   drain, over fixed-shape rail/slice arrays, with the fabric's
   deterministic fault schedule compiled into per-rail window arrays
   (`Fabric.fault_window_arrays`) and per-seed jitters applied to fault
   onset/duration/depth. The `spray_sim` kernel runs one seed lane per
   thread and yields whole healing-time/throughput distributions in one
   launch (`spray_sweep`); its plain version is a lane-batched torch sim,
   and `simulate_spray_ref` is the op-for-op numpy twin both are pinned
   against, bit-exact at float64.

The model the MC layer runs is deliberately the *skeleton* of the engine,
not the engine: one plan stage, uniform slice length, one retry attempt,
round-granular clock advancement. Scenarios that need staged hops, backend
substitution chains, or app callbacks keep the full event-driven
`ScenarioRunner` path — the same scalar-fallback contract the engine-side
adapter follows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..analysis import hot_path
from ..device import default_device
from .fabric import FAR_WINDOW

__all__ = [
    "EngineJitCore",
    "SprayProgram",
    "make_draws",
    "simulate_spray_ref",
    "spray_single",
    "spray_sweep",
    "stack_draws",
    "sweep_lanes",
    "JIT_MIN",
    "JIT_MIN_FLOOR",
    "JIT_MIN_CEIL",
]


def _bucket(n: int, floor: int = 8) -> int:
    """Next power-of-two shape bucket (>= floor): bounds the number of
    distinct kernel shapes per scenario to O(log max_batch)."""
    return max(floor, 1 << (max(int(n), 1) - 1).bit_length())


# ---------------------------------------------------------------------------
# Engine-side adapter (`EngineConfig.jit_core`)
# ---------------------------------------------------------------------------

# Batches shorter than this stay on the numpy kernels: a round trip to the
# card costs far more than a small numpy gather, so the kernel path only
# pays off on fat waves/drains (elephant scenarios routinely run 64-256).
# Mirroring the WAVE_MIN tuner, the crossover adapts online from the same
# run-length / drain-size EWMAs unless traffic is inconclusive — and
# because both paths compute bit-identical results, the tuner can only ever
# change cost, never a scheduling decision. The values are the reference's.
JIT_MIN = 32
JIT_MIN_FLOOR = 16
JIT_MIN_CEIL = 64


class EngineJitCore:
    """Routes `choose_wave` / `on_complete_many` through the fixed-shape
    kernels, bit-identically to the numpy path. Stateless beyond counters
    and the tuned crossover: all telemetry state stays in the store's
    struct-of-arrays, gathered/scattered per call through the telemetry
    transport hooks, so the scalar path can take over at any batch.
    `device` is where the kernels run: None means CUDA, which raises
    without a card; "cpu" runs their plain torch versions."""

    def __init__(self, policy, store, device=None):
        self.policy = policy
        self.store = store
        from ..kernels.tent_core import Staging

        self.device = default_device(device)
        self.staging = Staging(self.device)
        self.min_batch = JIT_MIN
        self.waves = 0  # batches actually dispatched through the kernel chooser
        self.drains = 0  # batches actually dispatched through the kernel drain

    def tune(self, signal: float) -> None:
        """Online crossover tuning, same shape as `TentEngine._tune_wave_min`
        and driven by the same structural signal (run-length / drain-size
        EWMAs — never wall clock, so it stays deterministic)."""
        if signal >= 2.0 * JIT_MIN:
            self.min_batch = JIT_MIN_FLOOR
        elif signal <= 0.5 * JIT_MIN:
            self.min_batch = JIT_MIN_CEIL
        else:
            self.min_batch = JIT_MIN

    # -- wave chooser --------------------------------------------------------
    @hot_path
    def choose_wave(self, sc, lengths):
        """Kernel twin of `TentPolicy.choose_wave`: same gathers, same
        write-backs, padded to shape buckets. Returns int64
        `(choices, queued_at)` exactly like the numpy kernel."""
        from ..kernels.tent_core import ops as tent_core_ops

        policy, store = self.policy, self.store
        slots = sc.local_slot
        excluded = store.excluded_arr[slots]
        if sc.remote_any:
            excluded = excluded | (
                sc.has_remote & store.excluded_arr[sc.remote_slot_safe])
        if store.global_weight > 0.0:
            glocal = store.foreign_load_array(sc.local_links)
            gremote = store.foreign_load_array(sc.remote_links)
        else:
            glocal = gremote = sc.zeros
        n_c, n_s = len(slots), len(lengths)
        pc, ps = _bucket(n_c), _bucket(n_s)
        # written straight into the staging buffer; candidate pads score inf
        # in both the masked and the all-excluded-fallback pass (penalty inf
        # + excluded), slice pads are invalid
        q, gl, gr, bw, b0, b1, pen, ex, ln, valid = self.staging.choose_inputs(pc, ps)
        for col, vals, fill in ((q, store.queued_arr[slots], 0.0), (gl, glocal, 0.0),
                                (gr, gremote, 0.0), (bw, sc.bandwidth, 1.0),
                                (b0, store.beta0_arr[slots], 0.0),
                                (b1, store.beta1_arr[slots], 1.0),
                                (pen, sc.penalty, np.inf), (ex, excluded, 1.0)):
            col[:n_c] = vals
            col[n_c:] = fill
        ln[:n_s] = lengths
        ln[n_s:] = 0.0
        valid[:n_s] = 1.0
        valid[n_s:] = 0.0
        c, qa, qo, rr = tent_core_ops.choose_wave_staged(
            self.staging, pc, ps, policy._rr, policy.gamma)
        choices = c[:n_s]
        queued_at = qa[:n_s].astype(np.int64)
        store.queued_arr[slots] = qo[:n_c].astype(np.int64)  # line 11 charges, applied
        policy._rr = rr
        self.waves += 1
        return choices, queued_at

    # -- completion drain ----------------------------------------------------
    @hot_path
    def on_complete_many(self, slots, lengths, queued_at, t_obs) -> None:
        """Kernel twin of `TelemetryStore.on_complete_many`: full state
        vectors travel through the telemetry transport hooks; the batch is
        padded to a shape bucket, and only its first `len(slots)` (live)
        entries are drained, so the store's scratch row (slot `n`) keeps its
        gathered value and the write-back discards it."""
        from ..kernels.tent_core import ops as tent_core_ops

        store = self.store
        n = store.n
        ps = _bucket(n + 1)  # >= n+1: row n is the scratch slot
        m = len(slots)
        pm = _bucket(m)
        state, (sl, ln, qa, to) = self.staging.drain_inputs(ps, pm)
        store.gather_complete_state(ps, out=state)
        sl[:m] = slots
        ln[:m] = lengths
        qa[:m] = queued_at
        to[:m] = t_obs
        out = tent_core_ops.complete_many_staged(self.staging, ps, pm, m)
        store.scatter_complete_state(*out)
        self.drains += 1


# ---------------------------------------------------------------------------
# Fused Monte Carlo spray model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SprayProgram:
    """Fixed-shape compilation of one spray scenario: D rails (the resolved
    plan stage's candidate paths), `rounds` waves of `wave` slices of
    `length` bytes each, with the fabric's fault/degradation schedule as
    dense per-rail window arrays (src- and dst-side degradations kept
    separate because the fabric takes the min of the two effective
    bandwidths). Built by `repro.scenarios.sweep.compile_spray_program`;
    consumed by `spray_single` / `spray_sweep` / `simulate_spray_ref`."""

    n_rails: int
    rounds: int
    wave: int
    length: float
    gamma: float
    detect: float  # Fabric.FAIL_DETECT_LATENCY
    jitter: float  # per-transfer service-jitter sigma (Fabric jitter)
    bw_score: np.ndarray  # (D,) local-link nominal bw — Algorithm 1 scoring
    bw_src: np.ndarray  # (D,) source-side nominal bw — service time
    bw_dst: np.ndarray  # (D,) dest-side nominal bw (inf when single-ended)
    penalty: np.ndarray  # (D,) tier penalties
    latency: np.ndarray  # (D,) wire latency added after the busy chain
    beta0: np.ndarray  # (D,) EWMA state priors (telemetry cold start)
    beta1: np.ndarray
    ewma_alpha: np.ndarray
    beta0_alpha: np.ndarray
    fail_start: np.ndarray  # (D, Kf) union of src+dst fail windows
    fail_end: np.ndarray
    degs_start: np.ndarray  # (D, Ks) source-side degradations
    degs_end: np.ndarray
    degs_factor: np.ndarray
    degd_start: np.ndarray  # (D, Kd) dest-side degradations
    degd_end: np.ndarray
    degd_factor: np.ndarray

    def __post_init__(self):
        if not np.isfinite(self.penalty).any():
            raise ValueError("SprayProgram needs >= 1 tier-feasible rail")


def _seed(base_seed: int, seed_index: int) -> int:
    """The 32 bits a CPU `torch.Generator` keeps of its seed (mt19937),
    mixed from both numbers by numpy's `SeedSequence`."""
    if base_seed < 0 or seed_index < 0:
        raise ValueError(f"seeds must be >= 0: base_seed={base_seed}, seed_index={seed_index}")
    return int(np.random.SeedSequence([base_seed, seed_index]).generate_state(1)[0])


def make_draws(p: SprayProgram, *, base_seed: int = 0,
               seed_index: int = 0) -> Dict[str, np.ndarray]:
    """One seed's raw randomness, all drawn up front so the kernel, the
    plain torch sim and the numpy twin consume identical bits: window-jitter
    uniforms in [-1, 1] of shapes (D, Kf, 2), (D, Ks, 3) and (D, Kd, 3)
    (fault onset/duration, degradation onset/duration/depth), and the
    per-attempt service-jitter multipliers `jm = 1 + |N(0, 1)| / (1/sigma)`
    of shape (rounds, wave, 2) (the fabric's per-transfer jitter law).

    The rule: one CPU `torch.Generator` seeded with the first 32-bit word of
    `numpy.random.SeedSequence([base_seed, seed_index])` draws uf, us, ud,
    then the normals, in that order. A lane's draws therefore depend neither on the device nor on
    how many seeds a sweep runs, so a lane equals a single-seed run. (The
    reference draws from jax's PRNG, which gives other bits: the port's
    distributions are compared with `BENCH_mc.json`, its lanes bit for bit
    with `simulate_spray_ref` on these draws.)"""
    g = torch.Generator().manual_seed(_seed(base_seed, seed_index))

    def uniform(*shape):
        return torch.empty(shape, dtype=torch.float64).uniform_(-1.0, 1.0, generator=g)

    uf = uniform(p.n_rails, p.fail_start.shape[1], 2)
    us = uniform(p.n_rails, p.degs_start.shape[1], 3)
    ud = uniform(p.n_rails, p.degd_start.shape[1], 3)
    inv_sigma = math.inf if p.jitter == 0 else 1.0 / float(p.jitter)
    normal = torch.randn((p.rounds, p.wave, 2), generator=g, dtype=torch.float64)
    jm = 1.0 + normal.abs() / inv_sigma
    return {"uf": uf.numpy(), "us": us.numpy(), "ud": ud.numpy(), "jm": jm.numpy()}


def stack_draws(p: SprayProgram, n_seeds: int, *,
                base_seed: int = 0) -> Dict[str, np.ndarray]:
    """`make_draws` of seeds 0 .. n_seeds - 1, stacked on a leading lane
    axis."""
    lanes = [make_draws(p, base_seed=base_seed, seed_index=i) for i in range(n_seeds)]
    return {k: np.stack([d[k] for d in lanes]) for k in ("uf", "us", "ud", "jm")}

# Window jitter law (shared, op for op, by both backends): onsets scale
# multiplicatively (a window starting at 0 — e.g. a permanent rail derating
# — stays at 0), durations scale multiplicatively (a "forever" horizon
# stays forever), depths scale and clamp into (0, 1]. fj=0 reproduces the
# declared schedule exactly. Every multiply whose result would feed an add
# is written as a division instead, as in the reference (the kernel rounds
# every operation on its own anyway, so the form is kept only to give the
# same numbers).


def _inv_fj(fj: float) -> float:
    return math.inf if fj == 0 else 1.0 / float(fj)


def _jitter_windows_np(start, end, u, fj):
    inv = _inv_fj(fj)
    s = np.maximum(0.0, start * (1.0 + u[..., 0] / inv))
    scale1 = 1.0 + u[..., 1] / inv
    e = s + (end - start) / (1.0 / scale1)
    return s, e


def _select_np(scores, rr, gamma):
    s_min = scores.min()
    in_w = scores <= (1.0 + gamma) * s_min
    n_w = int(in_w.sum())
    k = int(rr) % max(n_w, 1)
    order = np.cumsum(in_w.astype(np.int64)) - 1
    match = np.where(in_w & (order == k),
                     np.arange(scores.shape[0]), scores.shape[0])
    return int(match.min())


def simulate_spray_ref(p: SprayProgram, draws: Dict[str, np.ndarray], *,
                       policy: str = "tent",
                       fault_jitter: float = 0.0) -> Tuple[float, ...]:
    """Numpy twin of the fused sim (the `spray_sim` kernel and its plain
    torch version), mirrored operation for operation at float64 (the parity
    tests assert exact equality). Returns
    `(throughput, healing_s, bytes_ok, lost, makespan)`."""
    if policy not in ("tent", "round_robin"):
        raise ValueError(f"unsupported sweep policy {policy!r}")
    D, R, W = p.n_rails, p.rounds, p.wave
    L = float(p.length)
    det = float(p.detect)
    gamma = float(p.gamma)
    fj = float(fault_jitter)
    uf, us, ud, jm = draws["uf"], draws["us"], draws["ud"], draws["jm"]
    inv = _inv_fj(fj)
    fs, fe = _jitter_windows_np(p.fail_start, p.fail_end, uf, fj)
    dss, dse = _jitter_windows_np(p.degs_start, p.degs_end, us, fj)
    dsf = np.clip(p.degs_factor * (1.0 + us[..., 2] / inv), 0.01, 1.0)
    dds, dde = _jitter_windows_np(p.degd_start, p.degd_end, ud, fj)
    ddf = np.clip(p.degd_factor * (1.0 + ud[..., 2] / inv), 0.01, 1.0)
    ext = lambda a, fill: np.concatenate(
        [np.asarray(a, dtype=np.float64), [fill]])
    bw_score = ext(p.bw_score, 1.0)
    bw_src = ext(p.bw_src, 1.0)
    bw_dst = ext(p.bw_dst, 1.0)
    pen = ext(p.penalty, np.inf)
    lat = ext(p.latency, 0.0)
    alpha = ext(p.ewma_alpha, 0.0)
    b0a = ext(p.beta0_alpha, 0.0)
    b0 = ext(p.beta0, 0.0)
    b1 = ext(p.beta1, 1.0)
    q = np.zeros(D + 1)
    busy = np.zeros(D + 1)
    rr = 0
    now = 0.0
    arange = np.arange(D + 1)

    def excluded_at(t):
        return np.any((fs + det <= t) & (t < fe + det), axis=1)

    def overlaps(d, s, e):
        return d < D and bool(np.any((fs[d] < e) & (fe[d] > s)))

    def degfac(start, end, fac, d, t):
        out = 1.0
        if d < D:
            for k in range(start.shape[1]):
                if start[d, k] <= t < end[d, k]:
                    out = out * fac[d, k]
        return out

    def effbw(d, t):
        return min(bw_src[d] * degfac(dss, dse, dsf, d, t),
                   bw_dst[d] * degfac(dds, dde, ddf, d, t))

    def choose(rr_, live=None):
        if policy == "tent":
            s = pen * (b0 + b1 * (q + L) / bw_score)
            mask = np.zeros(D + 1, dtype=bool)
            mask[:D] = excl if live is None else ~live
            mask[D] = True
            sx = np.where(mask, np.inf, s)
            se = sx if np.isfinite(sx.min()) else s
            return _select_np(se, rr_, gamma)
        rot = np.where(arange < D,
                       ((arange - rr_) % max(D, 1)).astype(np.float64), np.inf)
        if live is not None:
            rx = np.where(np.concatenate([live, [False]]), rot, np.inf)
            rot = rx if np.isfinite(rx.min()) else rot
        return _select_np(rot, 0, 0.0)

    ends_all = np.zeros((R, W))
    oks_all = np.zeros((R, W), dtype=bool)
    for r in range(R):
        excl = excluded_at(now)
        ds_r = np.zeros(W, dtype=np.int64)
        qat_r = np.zeros(W)
        for w in range(W):
            jm1, jm2 = float(jm[r, w, 0]), float(jm[r, w, 1])
            d1 = choose(rr)
            rr += 1
            q[d1] += L
            qat1 = q[d1]
            start1 = max(now, busy[d1])
            # service = (L * jm) / bw, as the reference computes it
            endb1 = start1 + (L * jm1) / effbw(d1, start1)
            f1 = overlaps(d1, start1, endb1)
            if not f1:
                busy[d1] = endb1
            else:
                q[d1] -= L
            t2 = start1 + det
            live = ~excluded_at(t2)
            d2 = choose(rr, live=live)
            if f1:
                rr += 1
                q[d2] += L
                qat2 = q[d2]
                start2 = max(t2, busy[d2])
                endb2 = start2 + (L * jm2) / effbw(d2, start2)
                f2 = overlaps(d2, start2, endb2)
                if not f2:
                    busy[d2] = endb2
                else:
                    q[d2] -= L
                ok = not f2
                d_f, endb_f, qat_f = d2, endb2, qat2
            else:
                ok = True
                d_f, endb_f, qat_f = d1, endb1, qat1
            ds_r[w] = d_f
            ends_all[r, w] = endb_f + lat[d_f]
            oks_all[r, w] = ok
            qat_r[w] = qat_f
        # completion-ordered EWMA drain (failures -> scratch row D)
        key_order = np.where(oks_all[r], ends_all[r], np.inf)
        order = np.argsort(key_order, kind="stable")
        for w in order:
            d = int(ds_r[w]) if oks_all[r, w] else D
            tob = ends_all[r, w] - now
            a = alpha[d]
            x = (qat_r[w] + L) / bw_score[d]
            sample = np.clip((tob - b0[d]) / (x if x > 0 else 1.0), 0.05, 1e4)
            if x > 0:
                b1[d] = (1 - a) * b1[d] + a * sample
            resid = max(0.0, tob - b1[d] * x)
            b0[d] = (1 - b0a[d]) * b0[d] + b0a[d] * resid
            q[d] = max(0.0, q[d] - L)
        if oks_all[r].any():
            now = float(np.max(np.where(oks_all[r], ends_all[r], -np.inf)))
        else:
            now = now + det
    total_ok = int(oks_all.sum())
    bytes_ok = total_ok * L
    makespan = now
    throughput = bytes_ok / max(makespan, 1e-12)
    ends_flat = np.where(oks_all, ends_all, np.inf).ravel()
    onsets = fs.ravel()
    valid = onsets < min(makespan, FAR_WINDOW * 0.5)
    healing = -1.0
    if valid.any():
        heal = np.full(onsets.shape, -np.inf)
        for i, o in enumerate(onsets):
            if valid[i]:
                after = ends_flat[ends_flat >= o]
                heal[i] = (after.min() - o) if after.size else np.inf
        healing = float(heal.max())
    lost = R * W - total_ok
    return (float(throughput), float(healing), float(bytes_ok),
            float(lost), float(makespan))


# -- the sweep entry points ---------------------------------------------------


def spray_sweep(p: SprayProgram, n_seeds: int, *, base_seed: int = 0,
                policy: str = "tent", fault_jitter: float = 0.0,
                device=None) -> Dict[str, np.ndarray]:
    """The Monte Carlo sweep: `n_seeds` independent fault draws, one
    `spray_sim` launch with one lane per seed on the card (None = CUDA), or
    the lane-batched plain torch sim on the CPU. Returns per-seed float64
    arrays keyed `throughput`, `healing_s`, `bytes_ok`, `lost`,
    `makespan`."""
    dev = default_device(device)
    return sweep_lanes(p, stack_draws(p, n_seeds, base_seed=base_seed), policy=policy,
                       fault_jitter=fault_jitter, device=dev)


def sweep_lanes(p: SprayProgram, draws: Dict[str, np.ndarray], *, policy: str = "tent",
                fault_jitter: float = 0.0, device=None) -> Dict[str, np.ndarray]:
    """`spray_sweep` on draws the caller already holds (`stack_draws`), so
    that several policies can share one draw of the seeds."""
    from ..kernels.spray_sim import ops as spray_ops

    out = spray_ops.spray_sim(p, draws, policy=policy, fault_jitter=fault_jitter,
                              device=default_device(device)).cpu().numpy()
    return {"throughput": out[:, 0], "healing_s": out[:, 1],
            "bytes_ok": out[:, 2], "lost": out[:, 3], "makespan": out[:, 4]}


def spray_single(p: SprayProgram, *, base_seed: int = 0, seed_index: int = 0,
                 policy: str = "tent", fault_jitter: float = 0.0,
                 device=None) -> Tuple[float, ...]:
    """One seed on its own:
    `(throughput, healing_s, bytes_ok, lost, makespan)`. Exact-equal to the
    matching lane of `spray_sweep` (pinned in tests/test_torch_mc_sweep.py)."""
    from ..kernels.spray_sim import ops as spray_ops

    dev = default_device(device)
    d = make_draws(p, base_seed=base_seed, seed_index=seed_index)
    draws = {k: v[None] for k, v in d.items()}
    out = spray_ops.spray_sim(p, draws, policy=policy, fault_jitter=fault_jitter,
                              device=dev).cpu().numpy()
    return tuple(float(v) for v in out[0])
