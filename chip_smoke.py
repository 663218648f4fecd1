#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

  env      the card's name and power limit (nvidia-smi), torch and CUDA
           versions, TF32 switched off, and the time to build the kernels
           from src/repro_torch/csrc with nvcc into build/kernels/.
  kernels  every kernel of the path (flash attention) against its plain
           torch version on the card, at the serving shape and the
           reference's edge shapes, with times at the serving shape.
  serve    full-width qwen2-0.5b (random f32 weights from a seed) served
           disaggregated: flash-attention prefill on node 0, the KV cache
           shipped through the TENT engine across a rail flap, greedy
           decode on node 1; checked against an unshipped decode, a
           plain-attention prefill and the replay-prefill entry point.
  profile  device time by op (torch.profiler) over one prefill and eight
           decode steps of the same model, and the device's busy share.

Then a {"kernels": [...]} summary and, last, {"ok": true, "device": ...}.
Any failed check raises and the script exits non-zero. Without a card it
exits non-zero before printing anything. It needs one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
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
EDGE_SHAPES = [(1, 200, 4, 2, 64), (1, 128, 4, 1, 128), (2, 256, 8, 2, 64)]
WINDOW_SHAPE = (1, 256, 4, 2, 64)

ARCH, BATCH, PROMPT, MAX_LEN, N_NEW = "qwen2-0.5b", 4, 1024, 1056, 32
REPLAY_PROMPT, REPLAY_NEW = 256, 16
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def flash_bound(B, S, H, K, D, dtype, window=0):
    """Least time for causal attention on these inputs: 4*D flops per live
    (query, key) pair against q, k, v, o moved once. Returns (ms, bound_by)."""
    q = np.arange(S)
    live = q + 1 if window <= 0 else np.minimum(q + 1, window)
    flops = 4.0 * D * float(live.sum()) * B * H
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    nbytes = (2 * B * S * H * D + 2 * B * S * K * D) * torch.finfo(dtype).bits // 8
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    fa_kernel.load()
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
    if out.dtype != dtype or out.shape != q.shape or not torch.isfinite(out).all():
        raise AssertionError(f"flash attention {shape} {dtype}: bad output")
    err = (out.float() - ref.float()).abs()
    tol = TOL[dtype]
    ok = bool((err <= tol + tol * ref.float().abs()).all())
    case = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
            "window": window, "max_abs_err": err.max().item(), "tol": tol}
    if not ok:
        raise AssertionError(f"flash attention disagrees with its plain version: {case}")
    return case, (q, k, v)


def phase_kernels() -> dict:
    fa_kernel.launches = 0  # this phase's launches: checks and timing only
    cases, timing = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        case, (q, k, v) = _check_case(SERVE_SHAPE, dtype, 0, seed=1)
        cases.append(case)
        B, S, H, K, D = SERVE_SHAPE
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        bound, bound_by = flash_bound(B, S, H, K, D, dtype)
        timing[case["dtype"]] = {
            "kernel_ms": cuda_ms(lambda: flash_attention(q, k, v, causal=True)),
            "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True), iters=5),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "bound_ms": bound, "bound_by": bound_by, "max_abs_err": case["max_abs_err"],
        }
    for shape in EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(_check_case(shape, dtype, 0, seed=2)[0])
    for window in (16, 64):
        cases.append(_check_case(WINDOW_SHAPE, torch.float32, window, seed=3)[0])
    checked = [{"name": "flash_attention", "check_launches": fa_kernel.launches, "cases": len(cases),
                "max_abs_err": {dt: max(c["max_abs_err"] for c in cases if c["dtype"] == dt)
                                for dt in ("float32", "bfloat16")}}]
    res = {"phase": "kernels", "checked": checked, "serving_shape": list(SERVE_SHAPE),
           "timing": timing, "cases": cases}
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


def phase_serve() -> dict:
    cfg = get_config(ARCH).with_(use_pallas=True, remat="none")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, dtype=torch.float32, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    torch.cuda.synchronize()
    steps = {}

    # 1. flash-attention prefill: one kernel launch per layer
    fa_kernel.launches = 0
    (logits, kv), prefill_ms = wall_ms(lambda: prefill_forward(cfg, params, prompts))
    if fa_kernel.launches != cfg.num_layers:
        raise AssertionError(f"prefill launched flash attention {fa_kernel.launches} times, "
                             f"expected {cfg.num_layers}")
    if logits.shape != (BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not finite or misshapen")
    steps["prefill"] = {"wall_ms": prefill_ms, "flash_launches": fa_kernel.launches,
                        "cache_shape": list(kv["k"].shape)}

    # 2. pad the cache to max_len (decode width)
    pad = MAX_LEN - PROMPT
    cache = {name: F.pad(t, (0, 0, 0, 0, 0, pad)) for name, t in kv.items()}

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
        lambda: greedy_decode(cfg, params, shipped, logits, PROMPT, N_NEW))
    steps["decode"] = {"wall_ms": decode_ms, "tokens": N_NEW,
                       "decode_tok_s": BATCH * N_NEW / (decode_ms / 1e3)}
    # the main path ends here; the launch count was set to 0 before step 1,
    # and the checks below launch the kernel again
    main_launches = fa_kernel.launches
    if main_launches != cfg.num_layers:
        raise AssertionError(f"the main path launched flash attention {main_launches} times, "
                             f"expected {cfg.num_layers}")

    # 5. the same decode from the unshipped cache: identical tokens
    local, local_ms = wall_ms(lambda: greedy_decode(cfg, params, cache, logits, PROMPT, N_NEW))
    if not np.array_equal(tokens, local):
        raise AssertionError("shipped-cache tokens differ from unshipped-cache tokens")
    steps["unshipped_decode"] = {"tokens_equal": True, "wall_ms": local_ms,
                                 "decode_tok_s": BATCH * N_NEW / (local_ms / 1e3)}

    # 6. plain-attention prefill: logits and K/V within 2e-3 of the kernel's
    plain_cfg = cfg.with_(use_pallas=False)
    (plain_logits, plain_kv), plain_ms = wall_ms(
        lambda: prefill_forward(plain_cfg, params, prompts))
    steps["plain_prefill"] = {
        "wall_ms": plain_ms,
        "logits_max_abs_err": _close("logits", logits, plain_logits),
        "k_max_abs_err": _close("k", kv["k"], plain_kv["k"]),
        "v_max_abs_err": _close("v", kv["v"], plain_kv["v"]),
    }
    del plain_kv

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
    k_cache = {n: F.pad(t, (0, 0, 0, 0, 0, REPLAY_NEW)) for n, t in k_cache.items()}
    k_tokens = greedy_decode(cfg, params, k_cache, k_logits, REPLAY_PROMPT, REPLAY_NEW)
    steps["replay_generate"] = {
        "wall_ms": gen_ms, "kv_bytes": result.kv_bytes,
        "kv_transfer_seconds": result.kv_transfer_seconds,
        "equals_monolithic": True, "slices_retried": engine.slices_retried - retried_before,
        "tokens_agree_kernel_vs_replay_prefill": int((k_tokens == result.tokens).sum()),
        "tokens_compared": int(result.tokens.size),
    }
    res = {"phase": "serve", "arch": ARCH, "batch": BATCH, "prompt": PROMPT,
           "max_len": MAX_LEN, "new_tokens": N_NEW, "dtype": "float32",
           "main_path_flash_launches": main_launches, "steps": steps}
    emit(res)
    return res, (cfg, params, prompts)


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
    """Where the serve phase's time goes: one flash-attention prefill and
    eight greedy decode steps, each profiled once after a warm call."""
    prefill = lambda: prefill_forward(cfg, params, prompts)  # noqa: E731
    logits, kv = prefill()
    cache = {name: F.pad(t, (0, 0, 0, 0, 0, MAX_LEN - PROMPT)) for name, t in kv.items()}
    decode = lambda: greedy_decode(cfg, params, cache, logits, PROMPT, 9)  # noqa: E731
    decode()
    res = {"phase": "profile", "prefill": _profiled(prefill), "decode_8_steps": _profiled(decode)}
    emit(res)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 1
    phase_env()
    kern = phase_kernels()
    serve, model = phase_serve()  # counts launches from prefill through decode only
    launches = serve["main_path_flash_launches"]
    phase_profile(*model)
    main_case = kern["timing"]["float32"]  # the serving path runs in float32
    emit({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
