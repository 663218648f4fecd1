#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

  env      the card's name and power limit (nvidia-smi), torch and CUDA
           versions, TF32 switched off, and the time to build the kernels
           from src/repro_torch/csrc with nvcc into build/kernels/ (one nvcc
           per source, all started together).
  kernels  every kernel of the paths (flash attention, SSD scan) against
           its plain torch version on the card, at the serving shapes and
           the reference's edge shapes, with times and bounds at the
           serving shapes.
  serve    one phase per model, full width, random f32 weights from a seed,
           served disaggregated: kernel prefill on node 0, the decode cache
           shipped through the TENT engine across a rail flap, greedy
           decode on node 1; checked against an unshipped decode, a plain
           prefill (use_pallas=False) and the replay-prefill entry point.
             qwen2-0.5b   B=4, 1024-token prompts (flash attention)
             mamba2-370m  B=4, 1024-token prompts (SSD scan)
             hymba-1.5b   B=2, 3072-token prompts, window 2048 (both)
  profile  device time by op (torch.profiler) over one prefill and eight
           decode steps of each model, and the device's busy share.

Then a {"kernels": [...]} summary and, last, {"ok": true, "device": ...}.
Any failed check raises and the script exits non-zero. Without a card it
exits non-zero before printing anything. It needs one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import EngineConfig, FabricSpec, HealthConfig, NodeSpec, TentEngine  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.models import init_params, prefill_forward  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DisaggregatedServer,
    bytes_to_tree,
    greedy_decode,
    monolithic_generate,
    tree_to_bytes,
)

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12  # CUDA cores, TF32 off
HBM_BPS = 3.35e12

TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}  # tests/test_kernels.py:14-15
SERVE_SHAPE = (4, 1024, 14, 2, 64)  # (B, S, H, K, D): qwen2-0.5b prefill below
HYMBA_FLASH_SHAPE, HYMBA_WINDOW = (2, 3072, 25, 5, 64), 2048  # hymba-1.5b prefill
EDGE_SHAPES = [(1, 200, 4, 2, 64), (1, 128, 4, 1, 128), (2, 256, 8, 2, 64)]
WINDOW_SHAPE = (1, 256, 4, 2, 64)
# SSD scan: (B, S, H, P, N, chunk)
SSD_SERVE_SHAPE = (4, 1024, 32, 64, 128, 128)  # mamba2-370m prefill below
SSD_HYMBA_SHAPE = (2, 3072, 50, 64, 16, 128)  # hymba-1.5b prefill below
SSD_TAIL_SHAPES = [(2, 100, 32, 64, 128, 128), (1, 200, 50, 64, 16, 128)]
SSD_STATE_SHAPE = (2, 256, 8, 64, 128, 64)

# (arch, batch, prompt, new tokens); replay checks on 256-token prompts
SERVES = [("qwen2-0.5b", 4, 1024, 32), ("mamba2-370m", 4, 1024, 32), ("hymba-1.5b", 2, 3072, 32)]
REPLAY_PROMPT, REPLAY_NEW = 256, 16
SEED = 0

COUNTERS = {"flash_attention": fa_kernel, "ssd_scan": ssd_kernel}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches() -> None:
    for mod in COUNTERS.values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in COUNTERS.items()}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _bound(flops, nbytes, dtype):
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound(B, S, H, K, D, dtype, window=0):
    """Least time for causal attention on these inputs: 4*D flops per live
    (query, key) pair against q, k, v, o moved once. Returns (ms, bound_by)."""
    q = np.arange(S)
    live = q + 1 if window <= 0 else np.minimum(q + 1, window)
    flops = 4.0 * D * float(live.sum()) * B * H
    nbytes = (2 * B * S * H * D + 2 * B * S * K * D) * torch.finfo(dtype).bits // 8
    return _bound(flops, nbytes, dtype)


def ssd_bound(B, S, H, P, N, chunk, dtype, with_state=False):
    """Least time for the SSD scan on these inputs, each product counted
    once: C B^T once per (batch, chunk) over its causal half (2N flops per
    pair i >= j), the intra-chunk product over the causal half (2P per pair
    and head), C state^T and the state update (2 L P N each per batch, head
    and chunk), for the S steps the data has (a ragged last chunk counts
    its own length). Bytes: x, a, B, C (and the fp32 initial state) read
    once, y and the fp32 final state written once. Returns (ms, bound_by)."""
    lens = [min(chunk, S - t0) for t0 in range(0, S, chunk)]
    pairs = sum(n * (n + 1) / 2 for n in lens)
    flops = B * (2 * N * pairs + H * (2 * P * pairs + 4.0 * S * P * N))
    el = torch.finfo(dtype).bits // 8
    nbytes = el * (2 * B * S * H * P + B * S * H + 2 * B * S * N) + 4 * B * H * P * N * (
        2 if with_state else 1)
    return _bound(flops, nbytes, dtype)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# --------------------------------------------------------------------------- env
def phase_env() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(card, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(COUNTERS)) as pool:  # one nvcc per source, in parallel
        list(pool.map(lambda mod: mod.load(), COUNTERS.values()))
    build_s = time.perf_counter() - t0
    env = {
        "phase": "env",
        "nvidia_smi": card,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "kernel_build_s": build_s,
    }
    emit(env)
    return env


# ----------------------------------------------------------------------- kernels
def _agree(name, out, ref, dtype):
    if out.dtype != ref.dtype or out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: bad output {out.dtype} {tuple(out.shape)}")
    err = (out.float() - ref.float()).abs()
    tol = TOL[dtype]
    return bool((err <= tol + tol * ref.float().abs()).all()), err.max().item()


def _qkv(shape, dtype, seed):
    B, S, H, K, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(B, S, H, D), mk(B, S, K, D), mk(B, S, K, D)


def _check_case(shape, dtype, window, seed):
    q, k, v = _qkv(shape, dtype, seed)
    out = flash_attention(q, k, v, causal=True, window=window)
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    ok, err = _agree(f"flash attention {shape} {dtype}", out, ref, dtype)
    case = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
            "window": window, "max_abs_err": err, "tol": TOL[dtype]}
    if not ok:
        raise AssertionError(f"flash attention disagrees with its plain version: {case}")
    return case, (q, k, v)


def _ssd_inputs(shape, dtype, seed, with_state=False):
    """x (B,S,H,P) scaled by 0.5, a = -0.3|N(0,1)|, and B, C as strided
    slices of one (B, S, 2N + 8) tensor, as the model slices them out of
    its projection; the reference's kernel-test scales."""
    B, S, H, P, N, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(B, S, H, P, generator=g, device="cuda") * 0.5).to(dtype)
    a = (-torch.randn(B, S, H, generator=g, device="cuda").abs() * 0.3).to(dtype)
    bc = (torch.randn(B, S, 2 * N + 8, generator=g, device="cuda") * 0.5).to(dtype)
    s0 = torch.randn(B, H, P, N, generator=g, device="cuda") if with_state else None
    return x, a, bc[..., :N], bc[..., N:2 * N], s0


def _check_ssd(shape, dtype, seed, with_state=False):
    x, a, Bm, Cm, s0 = _ssd_inputs(shape, dtype, seed, with_state)
    y, fin = ssd_chunked(x, a, Bm, Cm, chunk=shape[5], initial_state=s0)
    y_ref, fin_ref = ssd_scan_ref(x, a, Bm, Cm, s0)
    torch.cuda.synchronize()
    ok_y, err_y = _agree(f"ssd scan y {shape} {dtype}", y, y_ref, dtype)
    ok_s, err_s = _agree(f"ssd scan state {shape} {dtype}", fin, fin_ref.to(dtype), dtype)
    case = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
            "initial_state": with_state, "max_abs_err": max(err_y, err_s),
            "y_max_abs_err": err_y, "state_max_abs_err": err_s, "tol": TOL[dtype]}
    if not (ok_y and ok_s):
        raise AssertionError(f"ssd scan disagrees with its plain version: {case}")
    return case, (x, a, Bm, Cm, s0)


def _flash_timing(shape, dtype, case, window=0):
    q, k, v = _qkv(shape, dtype, seed=1)
    B, S, H, K, D = shape
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bound, bound_by = flash_bound(B, S, H, K, D, dtype, window)
    if window:
        lib = None  # SDPA takes no sliding window without an explicit mask
    else:
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    return {
        "shape": list(shape), "window": window,
        "kernel_ms": cuda_ms(lambda: flash_attention(q, k, v, causal=True, window=window)),
        "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True, window=window),
                            iters=5),
        "library_ms": lib, "bound_ms": bound, "bound_by": bound_by,
        "max_abs_err": case["max_abs_err"],
    }


def _ssd_timing(shape, dtype, case, inputs):
    x, a, Bm, Cm, _ = inputs
    bound, bound_by = ssd_bound(*shape, dtype)
    return {
        "shape": list(shape),
        "kernel_ms": cuda_ms(lambda: ssd_chunked(x, a, Bm, Cm, chunk=shape[5])),
        "plain_ms": cuda_ms(lambda: ssd_scan_ref(x, a, Bm, Cm), iters=2, warmup=1),
        "library_ms": None,  # no single PyTorch call computes the SSD scan
        "bound_ms": bound, "bound_by": bound_by, "max_abs_err": case["max_abs_err"],
    }


def phase_kernels() -> dict:
    reset_launches()  # this phase's launches: checks and timing only
    fa_cases, ssd_cases, timing = [], [], {"flash_attention": {}, "ssd_scan": {}}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        case, _ = _check_case(SERVE_SHAPE, dtype, 0, seed=1)
        fa_cases.append(case)
        timing["flash_attention"][dt] = _flash_timing(SERVE_SHAPE, dtype, case)
        case, _ = _check_case(HYMBA_FLASH_SHAPE, dtype, HYMBA_WINDOW, seed=1)
        fa_cases.append(case)
        timing["flash_attention"][f"{dt}_hymba"] = _flash_timing(
            HYMBA_FLASH_SHAPE, dtype, case, HYMBA_WINDOW)
        for shape in (SSD_SERVE_SHAPE, SSD_HYMBA_SHAPE):
            case, inputs = _check_ssd(shape, dtype, seed=4)
            ssd_cases.append(case)
            key = dt if shape == SSD_SERVE_SHAPE else f"{dt}_hymba"
            timing["ssd_scan"][key] = _ssd_timing(shape, dtype, case, inputs)
            del inputs
        for shape in SSD_TAIL_SHAPES:
            ssd_cases.append(_check_ssd(shape, dtype, seed=5)[0])
        ssd_cases.append(_check_ssd(SSD_STATE_SHAPE, dtype, seed=6, with_state=True)[0])
    for shape in EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            fa_cases.append(_check_case(shape, dtype, 0, seed=2)[0])
    for window in (16, 64):
        fa_cases.append(_check_case(WINDOW_SHAPE, torch.float32, window, seed=3)[0])
    checks = read_launches()
    checked = []
    for name, cases in (("flash_attention", fa_cases), ("ssd_scan", ssd_cases)):
        checked.append({"name": name, "check_launches": checks[name], "cases": len(cases),
                        "max_abs_err": {dt: max(c["max_abs_err"] for c in cases
                                                if c["dtype"] == dt)
                                        for dt in ("float32", "bfloat16")}})
    res = {"phase": "kernels", "checked": checked, "timing": timing,
           "cases": {"flash_attention": fa_cases, "ssd_scan": ssd_cases}}
    emit(res)
    return res


# ------------------------------------------------------------------------- serve
def build_engine() -> TentEngine:
    """The engine `ScenarioRunner.build_engine` makes for the reference's
    disagg_prefill_decode scenario: its two-node fabric (nic_bw 1 GB/s, the
    rest TopologyParams defaults), EngineParams defaults, policy "tent",
    seed 0. The rail flap is scheduled by the caller, over the KV flow."""
    fabric = FabricSpec(n_nodes=2, node=NodeSpec(n_numa=2, n_gpus=8, n_nics=8),
                        nic_bw=1e9, tcp_bw=3e9, has_nvlink=True, has_gpudirect=True,
                        has_mnnvl=False, has_ub=False)
    config = EngineConfig(
        policy="tent", slice_bytes=64 * 1024, max_slices=64, max_inflight=256, gamma=0.05,
        reset_interval=1.0, wave=True, candidate_cache=True, wave_complete=True,
        wave_min=None, jit_core=False, calendar_queue=False,
        health=HealthConfig(probe_interval=0.02, retry_limit=8))
    return TentEngine(fabric, config=config, seed=SEED)


def _engine_counters(engine: TentEngine) -> dict:
    return {"waves": engine.waves, "slices_issued": engine.slices_issued,
            "slices_retried": engine.slices_retried}


def _close(name, got, want, tol=2e-3):
    err = (got.float() - want.float()).abs()
    if not bool((err <= tol + tol * want.float().abs()).all()):
        raise AssertionError(f"{name}: kernel prefill vs plain prefill max err {err.max().item()}")
    return err.max().item()


def decode_cache(cfg, cache: dict, max_len: int) -> dict:
    """A decode cache from a prefill cache, in new tensors (decoding writes
    into its cache): K/V of a cache without a window grow to `max_len`; a
    window's ring and the SSM leaves (which have no length axis) are copied
    as they are."""
    pad = cfg.sliding_window == 0
    return {name: F.pad(t, (0, 0, 0, 0, 0, max_len - t.shape[2]))
            if pad and name in ("k", "v") else t.clone() for name, t in cache.items()}


def expected_launches(cfg) -> dict:
    """Kernel launches of one prefill: one per attention layer and one per
    Mamba2 layer."""
    has_attn = cfg.arch_type != "ssm"
    has_ssm = cfg.arch_type == "ssm" or cfg.hybrid
    return {"flash_attention": cfg.num_layers if has_attn else 0,
            "ssd_scan": cfg.num_layers if has_ssm else 0}


def phase_serve(arch: str, batch: int, prompt_len: int, n_new: int):
    cfg = get_config(arch).with_(use_pallas=True, remat="none")
    max_len = prompt_len + n_new
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, dtype=torch.float32, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device="cuda")
    torch.cuda.synchronize()
    want = expected_launches(cfg)
    steps = {}

    # the main path: prefill, handoff, decode, with every count set to 0 here
    reset_launches()
    # 1. kernel prefill: one launch per layer of each kernel it runs
    (logits, kv), prefill_ms = wall_ms(lambda: prefill_forward(cfg, params, prompts))
    if read_launches() != want:
        raise AssertionError(f"{arch} prefill launched {read_launches()}, expected {want}")
    if logits.shape != (batch, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch} prefill logits are not finite or misshapen")
    steps["prefill"] = {"wall_ms": prefill_ms, "launches": read_launches(),
                        "cache_shapes": {n: list(t.shape) for n, t in kv.items()}}

    # 2. the decode cache (K/V without a window padded to max_len)
    cache = decode_cache(cfg, kv, max_len)

    # 3. ship it through TENT, with a rail flap over the flow
    engine = build_engine()
    server = DisaggregatedServer(engine, cfg, params)

    def handoff():
        data, metas = tree_to_bytes(cache)
        t0 = engine.fabric.now
        flap = engine.topology.rdma_nic(0, 1)
        engine.fabric.schedule_failure(flap.link_id, at=t0 + 0.002, recover_at=t0 + 0.02)
        done = {}
        dst, _ = server.ship_kv_async(data, lambda r: done.setdefault("res", r))
        engine.run_until_idle()
        res = done["res"]
        if not res.ok:
            raise AssertionError(f"KV handoff failed: {res.error}")
        if not res.completed_at > t0 + 0.002:
            raise AssertionError("the rail flap did not overlap the KV flow")
        return bytes_to_tree(dst.read(0, data.size), cache), data.size, metas, res

    (shipped, kv_bytes, metas, res), handoff_ms = wall_ms(handoff)
    for name in cache:
        if not torch.equal(shipped[name], cache[name]):
            raise AssertionError(f"shipped cache[{name!r}] differs from the prefill's")
    steps["handoff"] = {"wall_ms": handoff_ms, "kv_bytes": kv_bytes, "metas": metas,
                        "kv_transfer_seconds": res.completed_at - res.submitted_at,
                        **_engine_counters(engine)}

    # 4. decode on node 1 from the shipped cache
    tokens, decode_ms = wall_ms(
        lambda: greedy_decode(cfg, params, shipped, logits, prompt_len, n_new))
    steps["decode"] = {"wall_ms": decode_ms, "tokens": n_new,
                       "decode_tok_s": batch * n_new / (decode_ms / 1e3)}
    # the main path ends here; the checks below launch the kernels again
    main_launches = read_launches()
    if main_launches != want:
        raise AssertionError(f"the {arch} main path launched {main_launches}, expected {want}")

    # 5. the same decode from the unshipped cache: identical tokens
    local_cache = decode_cache(cfg, kv, max_len)
    local, local_ms = wall_ms(
        lambda: greedy_decode(cfg, params, local_cache, logits, prompt_len, n_new))
    if not np.array_equal(tokens, local):
        raise AssertionError("shipped-cache tokens differ from unshipped-cache tokens")
    steps["unshipped_decode"] = {"tokens_equal": True, "wall_ms": local_ms,
                                 "decode_tok_s": batch * n_new / (local_ms / 1e3)}
    del shipped, local_cache, cache

    # 6. plain prefill: logits and every cache leaf within 2e-3 of the kernel's
    plain_cfg = cfg.with_(use_pallas=False)
    (plain_logits, plain_kv), plain_ms = wall_ms(
        lambda: prefill_forward(plain_cfg, params, prompts))
    steps["plain_prefill"] = {
        "wall_ms": plain_ms,
        "logits_max_abs_err": _close("logits", logits, plain_logits),
        **{f"{n}_max_abs_err": _close(n, kv[n], plain_kv[n]) for n in sorted(kv)},
    }
    del plain_kv, kv

    # 7. the reference's own entry point: replay prefill, disaggregated,
    #    against monolithic generation
    short = prompts[:, :REPLAY_PROMPT].contiguous()
    replay_len = REPLAY_PROMPT + REPLAY_NEW
    retried_before = engine.slices_retried
    result, gen_ms = wall_ms(lambda: server.generate(short, REPLAY_NEW, replay_len))
    mono = monolithic_generate(cfg, params, short, REPLAY_NEW, replay_len)
    if not np.array_equal(result.tokens, mono):
        raise AssertionError("server.generate tokens differ from monolithic_generate")
    # not gated: kernel prefill vs replay prefill on the same short prompts
    k_logits, k_cache = prefill_forward(cfg, params, short)
    k_tokens = greedy_decode(cfg, params, decode_cache(cfg, k_cache, replay_len), k_logits,
                             REPLAY_PROMPT, REPLAY_NEW)
    steps["replay_generate"] = {
        "wall_ms": gen_ms, "kv_bytes": result.kv_bytes,
        "kv_transfer_seconds": result.kv_transfer_seconds,
        "equals_monolithic": True, "slices_retried": engine.slices_retried - retried_before,
        "tokens_agree_kernel_vs_replay_prefill": int((k_tokens == result.tokens).sum()),
        "tokens_compared": int(result.tokens.size),
    }
    out = {"phase": "serve", "arch": arch, "batch": batch, "prompt": prompt_len,
           "max_len": max_len, "new_tokens": n_new, "dtype": "float32",
           "main_path_launches": main_launches, "steps": steps}
    emit(out)
    return out, (cfg, params, prompts)


# ----------------------------------------------------------------------- profile
def _profiled(fn, top: int = 8) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler, CUPTI).
    Only device-side events are summed: an aten op's device time is its
    kernels', which are listed on their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    return {"wall_ms": wall, "device_ms": busy, "device_busy_share": busy / wall,
            "top": [{"kernel": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in rows[:top]]}


def phase_profile(cfg, params, prompts) -> dict:
    """Where a serve phase's time goes: one kernel prefill and eight greedy
    decode steps, each profiled once after a warm call."""
    prompt_len = prompts.shape[1]
    prefill = lambda: prefill_forward(cfg, params, prompts)  # noqa: E731
    logits, kv = prefill()
    cache = decode_cache(cfg, kv, prompt_len + 9)
    decode = lambda: greedy_decode(cfg, params, cache, logits, prompt_len, 9)  # noqa: E731
    decode()
    res = {"phase": "profile", "arch": cfg.name, "prefill": _profiled(prefill),
           "decode_8_steps": _profiled(decode)}
    emit(res)
    return res


def _summary(name, source, replaces, launches, timing) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": timing["max_abs_err"], "ms": timing["kernel_ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": timing["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 1
    phase_env()
    kern = phase_kernels()
    launches = {name: {} for name in COUNTERS}
    for arch, batch, prompt_len, n_new in SERVES:
        serve, model = phase_serve(arch, batch, prompt_len, n_new)  # counts its main path only
        for name, n in serve["main_path_launches"].items():
            if n:
                launches[name][arch] = n
        phase_profile(*model)
        del serve, model
        torch.cuda.empty_cache()
    t = kern["timing"]  # the serving paths run in float32
    emit({"kernels": [
        _summary("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:89",
                 launches["flash_attention"], t["flash_attention"]["float32"]),
        _summary("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:71",
                 launches["ssd_scan"], t["ssd_scan"]["float32"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
