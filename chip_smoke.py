#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

  env      the card's name and power limit (nvidia-smi), torch and CUDA
           versions, TF32 switched off, the time to build the kernels from
           src/repro_torch/csrc with nvcc into build/kernels/ (one nvcc per
           source, all started together), and the HGMMA (wgmma)
           instructions of each kernel in the built libraries' SASS.
  kernels  every kernel of the paths (flash attention, SSD scan, KV-page
           pack and unpack) against its plain torch version on the card, at
           the serving shapes and the reference's edge shapes, with times
           and bounds at the serving shapes. The KV-page kernels are held
           bit for bit, and their index checks must raise.
  kv_path  the KV-page kernels' own entry points (`kv_pack`, `kv_unpack`),
           which no other path of the system runs: qwen2-0.5b's per-layer
           K|V pages gathered from one pool on the card into a transfer
           buffer and scattered into a second pool.
  serve    one phase per model, full width, random f32 weights from a seed,
           served disaggregated: kernel prefill on node 0, the decode cache
           shipped through the TENT engine across a rail flap, greedy
           decode on node 1; checked against an unshipped decode, a plain
           prefill (use_pallas=False) and the replay-prefill entry point.
             qwen2-0.5b   B=4, 1024-token prompts (flash attention)
             mamba2-370m  B=4, 1024-token prompts (SSD scan)
             hymba-1.5b   B=2, 3072-token prompts, window 2048 (both)
  serve_bf16  qwen2-0.5b and mamba2-370m the same way in bfloat16, the
           reference's default parameter type (flash attention and the SSD
           scan on the tensor cores), each prefill held against an f32
           evaluation of the same bf16 weights no further than 1.5x the
           plain bf16 prefill is.
  profile  device time by op (torch.profiler) over one prefill and eight
           decode steps of each serve phase, and the device's busy share.
  hicache  three-tier HiCache (GPU/CPU/disk pools of real bytes) for the
           full-width qwen2-0.5b on the disagg_prefill_decode engine: two
           4096-token conversations, the second demoting the first, which
           is then fetched back up; the promoted bytes must be those inserted.
  scenarios  the scenario runner over the 25-scenario library with its
           declared expectations (host work on the virtual clock); one line
           per scenario, and any violation fails the run.

Then a {"kernels": [...]} summary and, last, {"ok": true, "device": ...}.
Any failed check raises and the script exits non-zero. Without a card it
exits non-zero before printing anything. It needs one card.
"""
from __future__ import annotations

import json
import re
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
from repro_torch.core import TentEngine  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.kv_pack import kv_pack, kv_pack_ref, kv_unpack, kv_unpack_ref  # noqa: E402
from repro_torch.kernels.kv_pack import kernel as kv_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.models import init_params, prefill_forward  # noqa: E402
from repro_torch.scenarios import ScenarioRunner, get, names  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DisaggregatedServer,
    HiCache,
    bytes_to_tree,
    greedy_decode,
    kv_bytes_per_token,
    make_cpu_pool,
    make_disk_pool,
    make_gpu_pool,
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
# the reference's edge shapes, and S = 200 with D = 128 (not a multiple of
# the 64-key tile, the wide head's two column halves)
EDGE_SHAPES = [(1, 200, 4, 2, 64), (1, 128, 4, 1, 128), (2, 256, 8, 2, 64), (1, 200, 4, 1, 128)]
WINDOW_SHAPE = (1, 256, 4, 2, 64)  # windows 16 (inside one kv tile) and 64
# SSD scan: (B, S, H, P, N, chunk)
SSD_SERVE_SHAPE = (4, 1024, 32, 64, 128, 128)  # mamba2-370m prefill below
SSD_HYMBA_SHAPE = (2, 3072, 50, 64, 16, 128)  # hymba-1.5b prefill below
SSD_TAIL_SHAPES = [(2, 100, 32, 64, 128, 128), (1, 200, 50, 64, 16, 128)]
# short prompts: S = 5 takes chunk 8 and S = 40 chunk 64 (the wrapper's rule)
SSD_SHORT_SHAPES = [(2, 5, 32, 64, 128, 128), (2, 40, 50, 64, 16, 128)]
SSD_STATE_SHAPE = (2, 256, 8, 64, 128, 64)
# B and C rows 2N + 3 elements apart: not a multiple of 16 bytes in either type
SSD_MISALIGNED_SHAPE, SSD_MISALIGNED_PAD = (2, 300, 8, 64, 128, 128), 3
# KV pages: (num_pages, page_size, kv_dim, n). The reference's test shapes,
# ragged rows (kv_dim 3; page size 5 takes the 2-byte path in bf16), one
# page, and the whole pool in reverse order.
KV_CHECK_SHAPES = [(32, 16, 128, 8), (64, 8, 256, 64), (40, 16, 3, 7), (40, 5, 3, 9),
                   (33, 16, 128, 1), (64, 8, 256, "reverse")]
# serving geometry, pool and buffer both far larger than the 50 MB L2:
# qwen2-0.5b's per-layer K|V page (16 tokens x 2 kv heads x 64 x K,V) and
# hymba-1.5b's (16 x 5 x 64 x 2)
KV_QWEN2 = (131072, 16, 256, 8192)
KV_HYMBA = (32768, 16, 640, 4096)

# (arch, batch, prompt, new tokens, parameter type); replay checks on
# 256-token prompts
SERVES = [("qwen2-0.5b", 4, 1024, 32, torch.float32), ("mamba2-370m", 4, 1024, 32, torch.float32),
          ("hymba-1.5b", 2, 3072, 32, torch.float32), ("qwen2-0.5b", 4, 1024, 32, torch.bfloat16),
          ("mamba2-370m", 4, 1024, 32, torch.bfloat16)]
# a bf16 kernel prefill's logits may lie at most this many times as far from
# an f32 evaluation of the same bf16 weights as the plain bf16 prefill's do
BF16_GATE = 1.5
REPLAY_PROMPT, REPLAY_NEW = 256, 16
SEED = 0
# HiCache: full-width qwen2-0.5b pages of 64 tokens (786,432 bytes) in the
# reference example's three tiers, scaled to these pages
HICACHE_TIERS, HICACHE_PAGE_TOKENS, HICACHE_CONVO = (64, 128, 256), 64, 4096

# kernel name -> (module, launch-count attribute)
COUNTERS = {"flash_attention": (fa_kernel, "launches"), "ssd_scan": (ssd_kernel, "launches"),
            "kv_pack": (kv_kernel, "pack_launches"), "kv_unpack": (kv_kernel, "unpack_launches")}
LIBRARIES = (fa_kernel, ssd_kernel, kv_kernel)
# the SSD scan's kernels in profiler names: ssd_chunk_state, ssd_state_pass,
# ssd_chunk_scan, and in f32 ssd_chunk_cb
SSD_PREFIX = "ssd_"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


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


def device_ms_by_kernel(fn, iters: int = 10, match: str = "") -> dict:
    """Device time of one call of `fn` by kernel name: each kernel's own
    time from torch.profiler (CUPTI) over `iters` calls after a warm one, no
    host time. With `match`, only the kernels whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and match in e.key}


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of `fn`, all its kernels summed."""
    return sum(device_ms_by_kernel(fn, iters).values())


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


def sass_hgmma(lib_path) -> dict:
    """HGMMA (wgmma) instructions per kernel in a built library's SASS, by
    cuobjdump from the toolkit that built it; kernels named as in the
    source, with their template argument."""
    from repro_torch.kernels.build import _nvcc

    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            m = re.search(r"\d((?:ssd|flash)_\w+?)(?:ILi(\d+)E|E)", mangled)
            func = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")) if m else mangled
            counts[func] = 0
        elif func and "HGMMA" in line:
            counts[func] += 1
    return counts


# --------------------------------------------------------------------------- env
def phase_env() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(card, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source, in parallel
        list(pool.map(lambda mod: mod.load(), LIBRARIES))
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
        "sass_hgmma": {name: sass_hgmma(mod.load()._name)
                       for name, mod in (("flash_attention", fa_kernel), ("ssd_scan", ssd_kernel))},
    }
    emit(env)
    idle = [k for lib in env["sass_hgmma"].values() for k, n in lib.items() if "bf16" in k and not n]
    if idle:
        raise AssertionError(f"bf16 kernels without wgmma (no HGMMA in their SASS): {idle}")
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


def _ssd_inputs(shape, dtype, seed, with_state=False, bc_pad=8):
    """x (B,S,H,P) scaled by 0.5, a = -0.3|N(0,1)|, and B, C as strided
    slices of one (B, S, 2N + bc_pad) tensor, as the model slices them out
    of its projection; the reference's kernel-test scales."""
    B, S, H, P, N, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(B, S, H, P, generator=g, device="cuda") * 0.5).to(dtype)
    a = (-torch.randn(B, S, H, generator=g, device="cuda").abs() * 0.3).to(dtype)
    bc = (torch.randn(B, S, 2 * N + bc_pad, generator=g, device="cuda") * 0.5).to(dtype)
    s0 = torch.randn(B, H, P, N, generator=g, device="cuda") if with_state else None
    return x, a, bc[..., :N], bc[..., N:2 * N], s0


def _check_ssd(shape, dtype, seed, with_state=False, bc_pad=8):
    x, a, Bm, Cm, s0 = _ssd_inputs(shape, dtype, seed, with_state, bc_pad)
    y, fin = ssd_chunked(x, a, Bm, Cm, chunk=shape[5], initial_state=s0)
    y_ref, fin_ref = ssd_scan_ref(x, a, Bm, Cm, s0)
    torch.cuda.synchronize()
    ok_y, err_y = _agree(f"ssd scan y {shape} {dtype}", y, y_ref, dtype)
    ok_s, err_s = _agree(f"ssd scan state {shape} {dtype}", fin, fin_ref.to(dtype), dtype)
    case = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
            "initial_state": with_state, "bc_row_stride": Bm.stride(1),
            "max_abs_err": max(err_y, err_s),
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
        # SDPA has no window argument: the causal band goes in as a boolean mask
        pos = torch.arange(S, device="cuda")
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=band, enable_gqa=True)
    else:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    # not gated: how far the library call is from the plain version
    lib_err = (library().transpose(1, 2).float()
               - flash_attention_ref(q, k, v, causal=True, window=window).float()).abs().max()
    kernel = lambda: flash_attention(q, k, v, causal=True, window=window)  # noqa: E731
    # ms: back-to-back calls through the public wrapper, host work included
    # (CUDA events); device_ms: the kernels alone (profiler)
    return {
        "shape": list(shape), "window": window, "kernel_ms": cuda_ms(kernel),
        "kernel_device_ms": device_ms(kernel),
        "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True, window=window),
                            iters=5),
        "library_ms": cuda_ms(library), "library_device_ms": device_ms(library),
        "library_max_abs_err": lib_err.item(),
        "bound_ms": bound, "bound_by": bound_by, "max_abs_err": case["max_abs_err"],
    }


def _ssd_timing(shape, dtype, case, inputs):
    x, a, Bm, Cm, _ = inputs
    bound, bound_by = ssd_bound(*shape, dtype)
    kernel = lambda: ssd_chunked(x, a, Bm, Cm, chunk=shape[5])  # noqa: E731
    # ms: back-to-back calls through the public wrapper (CUDA events);
    # device_ms: the SSD kernels alone (profiler), summed and one by one
    by_kernel = device_ms_by_kernel(kernel, match=SSD_PREFIX)
    return {
        "shape": list(shape),
        "kernel_ms": cuda_ms(kernel), "kernel_device_ms": sum(by_kernel.values()),
        "kernel_device_ms_by_kernel": {re.search(r"ssd_\w+(?:<\d+>)?", k).group(0): v
                                       for k, v in by_kernel.items()},
        "plain_ms": cuda_ms(lambda: ssd_scan_ref(x, a, Bm, Cm), iters=2, warmup=1),
        "library_ms": None,  # no single PyTorch call computes the SSD scan
        "bound_ms": bound, "bound_by": bound_by, "max_abs_err": case["max_abs_err"],
    }


def kv_bound(n, page_bytes):
    """Least time for moving n pages: each moved page read once and written
    once, and the n int32 indices read once, at the card's memory rate; no
    arithmetic. Returns (ms, bound_by)."""
    return (2 * n * page_bytes + 4 * n) / HBM_BPS * 1e3, "bytes"


def _kv_pool(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _kv_indices(num_pages, n, gen):
    """n distinct random pages (all pages in reverse for n="reverse"), int32."""
    if n == "reverse":
        return torch.arange(num_pages - 1, -1, -1, device="cuda", dtype=torch.int32)
    return torch.randperm(num_pages, generator=gen, device="cuda")[:n].int()


def _check_kv(shape, dtype, seed):
    """Pack and unpack against their plain versions, bit for bit: the
    gathered buffer, the scattered pool, unpack in place (same storage,
    pages it does not name untouched), and a pack -> unpack round trip."""
    num_pages, page, dim, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = _kv_pool((num_pages, page, dim), dtype, g)
    idx = _kv_indices(num_pages, n, g)
    buf = kv_pack(pool, idx)
    want = kv_pack_ref(pool, idx)
    dst = _kv_pool((num_pages, page, dim), dtype, g)
    before, ptr = dst.clone(), dst.data_ptr()
    out = kv_unpack(dst, buf, idx)
    want_dst = kv_unpack_ref(before.clone(), buf, idx)
    restored = kv_unpack(torch.zeros_like(pool), kv_pack(pool, idx), idx)
    torch.cuda.synchronize()
    untouched = torch.ones(num_pages, dtype=torch.bool, device="cuda")
    untouched[idx.long()] = False
    checks = {
        "pack_equal": torch.equal(buf, want),
        "unpack_equal": torch.equal(out, want_dst),
        "unpack_in_place": out is dst and dst.data_ptr() == ptr,
        "untouched_pages_equal": torch.equal(dst[untouched], before[untouched]),
        "round_trip_equal": torch.equal(restored[idx.long()], pool[idx.long()]),
    }
    case = {"shape": [num_pages, page, dim, idx.numel()], "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": max((buf.float() - want.float()).abs().max().item(),
                               (out.float() - want_dst.float()).abs().max().item()),
            **checks}
    if not all(checks.values()):
        raise AssertionError(f"KV-page kernels disagree with their plain versions: {case}")
    return case


def _check_kv_refusals(dtype) -> dict:
    """A page named twice raises ValueError and an index outside the pool
    IndexError, for both kernels, and the pool is left as it was."""
    g = torch.Generator(device="cuda").manual_seed(9)
    pool = _kv_pool((16, 16, 128), dtype, g)
    before = pool.clone()
    seen = {}
    for label, bad, err in (("repeated", [3, 5, 3], ValueError), ("past_end", [2, 16], IndexError),
                            ("negative", [-1, 4], IndexError)):
        idx = torch.tensor(bad, device="cuda")
        buf = _kv_pool((len(bad), 16, 128), dtype, g)
        for name, call in (("kv_pack", lambda: kv_pack(pool, idx)),
                           ("kv_unpack", lambda: kv_unpack(pool, buf, idx))):
            try:
                call()
            except err:
                seen[f"{name}_{label}"] = err.__name__
            else:
                raise AssertionError(f"{name} took {label} indices {bad} without raising")
    torch.cuda.synchronize()
    if not torch.equal(pool, before):
        raise AssertionError("a refused KV-page call changed the pool")
    return seen


def _kv_timing(shape, dtype, case):
    """Kernel entry (indices already int32 on the card), the public wrapper
    (with its index checks), and the plain version (one torch indexing call,
    which is also the library yardstick), at a serving geometry."""
    num_pages, page, dim, n = shape
    g = torch.Generator(device="cuda").manual_seed(11)
    pool = _kv_pool((num_pages, page, dim), dtype, g)
    idx = _kv_indices(num_pages, n, g)
    buf = kv_kernel.kv_pack(pool, idx)
    bound, bound_by = kv_bound(n, page * dim * pool.element_size())
    res = {}
    for name, kern, wrapper, plain in (
            ("kv_pack", lambda: kv_kernel.kv_pack(pool, idx), lambda: kv_pack(pool, idx),
             lambda: kv_pack_ref(pool, idx)),
            ("kv_unpack", lambda: kv_kernel.kv_unpack(pool, buf, idx),
             lambda: kv_unpack(pool, buf, idx), lambda: kv_unpack_ref(pool, buf, idx))):
        plain_ms = cuda_ms(plain)
        res[name] = {"shape": list(shape), "page_bytes": page * dim * pool.element_size(),
                     "kernel_ms": cuda_ms(kern), "wrapper_ms": cuda_ms(wrapper),
                     "plain_ms": plain_ms, "library_ms": plain_ms,
                     "bound_ms": bound, "bound_by": bound_by, "max_abs_err": case["max_abs_err"]}
    return res


def phase_kernels() -> dict:
    reset_launches()  # this phase's launches: checks and timing only
    fa_cases, ssd_cases, timing = [], [], {"flash_attention": {}, "ssd_scan": {}}
    kv_cases, timing["kv_pack"], timing["kv_unpack"], refusals = [], {}, {}, {}
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
        for shape in SSD_TAIL_SHAPES + SSD_SHORT_SHAPES:
            ssd_cases.append(_check_ssd(shape, dtype, seed=5)[0])
        ssd_cases.append(_check_ssd(SSD_STATE_SHAPE, dtype, seed=6, with_state=True)[0])
        ssd_cases.append(_check_ssd(SSD_MISALIGNED_SHAPE, dtype, seed=7,
                                    bc_pad=SSD_MISALIGNED_PAD)[0])
        for i, shape in enumerate(KV_CHECK_SHAPES):
            kv_cases.append(_check_kv(shape, dtype, seed=20 + i))
        refusals[dt] = _check_kv_refusals(dtype)
        geometries = [("", KV_QWEN2)] + ([("_hymba", KV_HYMBA)] if dtype == torch.bfloat16 else [])
        for suffix, shape in geometries:
            case = _check_kv(shape, dtype, seed=30)
            kv_cases.append(case)
            for name, row in _kv_timing(shape, dtype, case).items():
                timing[name][f"{dt}{suffix}"] = row
    for shape in EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            fa_cases.append(_check_case(shape, dtype, 0, seed=2)[0])
    for window in (16, 64):
        for dtype in (torch.float32, torch.bfloat16):
            fa_cases.append(_check_case(WINDOW_SHAPE, dtype, window, seed=3)[0])
    checks = read_launches()
    checked = []
    for name, cases in (("flash_attention", fa_cases), ("ssd_scan", ssd_cases),
                        ("kv_pack", kv_cases), ("kv_unpack", kv_cases)):
        checked.append({"name": name, "check_launches": checks[name], "cases": len(cases),
                        "max_abs_err": {dt: max(c["max_abs_err"] for c in cases
                                                if c["dtype"] == dt)
                                        for dt in ("float32", "bfloat16")}})
    res = {"phase": "kernels", "checked": checked, "timing": timing, "kv_refusals": refusals,
           "cases": {"flash_attention": fa_cases, "ssd_scan": ssd_cases, "kv_pages": kv_cases}}
    emit(res)
    return res


# ----------------------------------------------------------------------- kv_path
def phase_kv_path() -> dict:
    """The KV-page kernels' main path, their own entry points: qwen2-0.5b's
    per-layer K|V pages (f32, as the serve phases run) named by a host-side
    page table, gathered from a pool on the card into a transfer buffer and
    scattered into a second pool; every count is set to 0 just before."""
    num_pages, page, dim, n = KV_QWEN2
    g = torch.Generator(device="cuda").manual_seed(SEED)
    src = _kv_pool((num_pages, page, dim), torch.float32, g)
    dst = torch.zeros_like(src)
    rng = np.random.default_rng(SEED)
    src_pages = rng.permutation(num_pages)[:n].astype(np.int32)
    dst_pages = rng.permutation(num_pages)[:n].astype(np.int64)
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    buf = kv_pack(src, src_pages)
    out = kv_unpack(dst, buf, dst_pages)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    want = {"flash_attention": 0, "ssd_scan": 0, "kv_pack": 1, "kv_unpack": 1}
    if launches != want:
        raise AssertionError(f"the KV-page path launched {launches}, expected {want}")

    moved = torch.equal(dst[torch.from_numpy(dst_pages).cuda()],
                        src[torch.from_numpy(src_pages).long().cuda()])
    rest = torch.ones(num_pages, dtype=torch.bool, device="cuda")
    rest[torch.from_numpy(dst_pages).cuda()] = False
    if not (out is dst and moved and not dst[rest].any()):
        raise AssertionError("the KV-page path did not move exactly the named pages")
    res = {"phase": "kv_path", "pool": [num_pages, page, dim], "pages": n,
           "bytes_moved": 2 * n * page * dim * 4, "wall_ms": wall, "launches": launches,
           "pages_equal": True}
    emit(res)
    return res


# ------------------------------------------------------------------------- serve
def build_engine() -> TentEngine:
    """The engine `ScenarioRunner.build_engine` makes for the
    disagg_prefill_decode scenario (its fabric, engine knobs, policy "tent"
    and seed), without the scenario's fault program: the rail flap is
    scheduled by the caller, over the KV flow."""
    spec = get("disagg_prefill_decode")
    return TentEngine(spec.topology.to_fabric_spec(),
                      config=spec.engine.to_engine_config("tent"), seed=spec.seed)


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
    Mamba2 layer; serving moves no KV pages through the page kernels."""
    has_attn = cfg.arch_type != "ssm"
    has_ssm = cfg.arch_type == "ssm" or cfg.hybrid
    return {"flash_attention": cfg.num_layers if has_attn else 0,
            "ssd_scan": cfg.num_layers if has_ssm else 0, "kv_pack": 0, "kv_unpack": 0}


def _as_f32(params):
    return {n: _as_f32(t) if isinstance(t, dict) else t.float() for n, t in params.items()}


def prefill_distances(cfg, params, prompts, logits) -> tuple:
    """How far a prefill's last-token logits lie from an f32 evaluation of
    the same weights through the plain path (the yardstick), beside how far
    the plain prefill in the weights' own type lies from it: (kernel,
    plain), each a max-abs distance. For bf16 weights the second says how
    much the type alone moves the logits."""
    plain_cfg = cfg.with_(use_pallas=False)
    want = prefill_forward(plain_cfg, _as_f32(params), prompts)[0]
    plain = prefill_forward(plain_cfg, params, prompts)[0]
    return ((logits.float() - want).abs().max().item(),
            (plain.float() - want).abs().max().item())


def phase_serve(arch: str, batch: int, prompt_len: int, n_new: int, dtype=torch.float32):
    cfg = get_config(arch).with_(use_pallas=True, remat="none")
    max_len = prompt_len + n_new
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, dtype=dtype, device="cuda")
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
    dt = str(dtype).removeprefix("torch.")
    if dtype != torch.float32:
        # 6'. accuracy, calibrated by the plain path in the same type
        kernel_dist, plain_dist = prefill_distances(cfg, params, prompts, logits)
        steps["accuracy"] = {"kernel_logits_max_abs_dist": kernel_dist,
                             "plain_logits_max_abs_dist": plain_dist,
                             "ratio": kernel_dist / plain_dist if plain_dist else None,
                             "gate": BF16_GATE}
        if not (np.isfinite(kernel_dist) and kernel_dist <= BF16_GATE * plain_dist):
            raise AssertionError(f"{arch} {dt} kernel prefill is {kernel_dist} from the f32 "
                                 f"yardstick, more than {BF16_GATE}x the plain prefill's "
                                 f"{plain_dist}")
        out = {"phase": f"serve_{dt.replace('float', 'f')}", "arch": arch, "batch": batch,
               "prompt": prompt_len, "max_len": max_len, "new_tokens": n_new, "dtype": dt,
               "main_path_launches": main_launches, "steps": steps}
        emit(out)
        return out, (cfg, params, prompts)

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
           "max_len": max_len, "new_tokens": n_new, "dtype": dt,
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
    flash = sum(e.self_device_time_total for e in rows if "flash_fwd" in e.key) / 1e3
    ssd = sum(e.self_device_time_total for e in rows if SSD_PREFIX in e.key) / 1e3
    return {"wall_ms": wall, "device_ms": busy, "device_busy_share": busy / wall,
            "flash_attention_ms": flash, "flash_attention_share": flash / busy if busy else 0.0,
            "ssd_scan_ms": ssd, "ssd_scan_share": ssd / busy if busy else 0.0,
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
    res = {"phase": "profile", "arch": cfg.name,
           "dtype": str(params["embed"].dtype).removeprefix("torch."), "prefill": _profiled(prefill),
           "decode_8_steps": _profiled(decode)}
    emit(res)
    return res


# ----------------------------------------------------------------------- hicache
def phase_hicache() -> dict:
    """The reference example's HiCache section at full width: qwen2-0.5b
    pages of 64 tokens in GPU/CPU/disk pools of real bytes on the
    disagg_prefill_decode engine (its rail flap included). Two conversations
    of 4096 tokens with seeded payloads; the second demotes the first down a
    tier, which is then fetched back to the GPU tier. Every promoted page
    must hold the bytes that were inserted."""
    cfg = get_config("qwen2-0.5b")
    engine, _ = ScenarioRunner(get("disagg_prefill_decode")).build_engine("tent")
    page_bytes = kv_bytes_per_token(cfg) * HICACHE_PAGE_TOKENS
    gpu, cpu, disk = HICACHE_TIERS
    hc = HiCache(engine, cfg,
                 gpu_pool=make_gpu_pool(engine, 0, 0, page_bytes=page_bytes, num_pages=gpu),
                 cpu_pool=make_cpu_pool(engine, 1, page_bytes=page_bytes, num_pages=cpu),
                 disk_pool=make_disk_pool(engine, 1, page_bytes=page_bytes, num_pages=disk),
                 page_tokens=HICACHE_PAGE_TOKENS)
    rng = np.random.default_rng(SEED)
    convo_a = list(range(HICACHE_CONVO))
    convo_b = list(range(10**6, 10**6 + HICACHE_CONVO))
    n_bytes = HICACHE_CONVO // HICACHE_PAGE_TOKENS * page_bytes
    pay_a = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    pay_b = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    t0 = time.perf_counter()
    demote_a = hc.insert(convo_a, pay_a)
    demote_b = hc.insert(convo_b, pay_b)
    tiers_after_insert = hc.tier_counts()
    fetch = hc.fetch_prefix(convo_a)
    wall = (time.perf_counter() - t0) * 1e3
    got = np.concatenate([p.pool.read_page(p) for p in fetch.pages])
    if tiers_after_insert["gpu"] != gpu or sum(tiers_after_insert.values()) != 2 * gpu:
        raise AssertionError(f"the second conversation did not demote the first: "
                             f"{tiers_after_insert}")
    if fetch.prefix_tokens != HICACHE_CONVO or fetch.promoted_pages == 0:
        raise AssertionError(f"the first conversation was not fetched back: {fetch}")
    if not np.array_equal(got, pay_a):
        raise AssertionError("promoted pages do not hold the inserted bytes")
    res = {"phase": "hicache", "arch": cfg.name, "kv_bytes_per_token": kv_bytes_per_token(cfg),
           "page_tokens": HICACHE_PAGE_TOKENS, "page_bytes": page_bytes,
           "pools_pages": {"gpu": gpu, "cpu": cpu, "disk": disk},
           "host_bytes": page_bytes * (gpu + cpu + disk),
           "demote_seconds": [demote_a, demote_b], "tiers_after_insert": tiers_after_insert,
           "tiers_after_fetch": hc.tier_counts(), "promoted_pages": fetch.promoted_pages,
           "fetch_virtual_seconds": fetch.transfer_seconds, "bytes_moved": fetch.bytes_moved,
           "bytes_promoted": hc.bytes_promoted, "bytes_demoted": hc.bytes_demoted,
           "hits": hc.hits, "misses": hc.misses, "promoted_bytes_equal": True,
           "slices_retried": engine.slices_retried, "wall_ms": wall}
    emit(res)
    return res


# --------------------------------------------------------------------- scenarios
def phase_scenarios() -> dict:
    """Every library scenario through the port's scenario runner, with its
    declared expectations; one line each. Any violation fails the run."""
    t0 = time.perf_counter()
    failed = {}
    for name in names():
        s0 = time.perf_counter()
        report = ScenarioRunner(get(name)).run()
        emit({"phase": "scenario", "scenario": name, "ok": report.ok,
              "violations": report.violations, "wall_s": time.perf_counter() - s0,
              "policies": {p: {"throughput": r.throughput, "recovery_ms": r.recovery_ms,
                               "stall_ms": r.stall_ms, "retries": r.retries}
                           for p, r in report.policies.items()}})
        if report.violations:
            failed[name] = report.violations
    if failed:
        raise AssertionError(f"scenario expectations violated: {failed}")
    res = {"phase": "scenarios", "scenarios": len(names()), "violations": 0,
           "wall_s": time.perf_counter() - t0}
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
    kv = phase_kv_path()  # counts its main path only
    for name in ("kv_pack", "kv_unpack"):
        launches[name]["kv_path"] = kv["launches"][name]
    for arch, batch, prompt_len, n_new, dtype in SERVES:
        # counts its main path only
        serve, model = phase_serve(arch, batch, prompt_len, n_new, dtype)
        path = arch if dtype == torch.float32 else f"{arch}/{serve['dtype']}"
        for name, n in serve["main_path_launches"].items():
            if n:
                launches[name][path] = n
        phase_profile(*model)
        del serve, model
        torch.cuda.empty_cache()
    phase_hicache()
    phase_scenarios()
    t = kern["timing"]  # float32 rows; the kernels line above has every dtype and shape
    emit({"kernels": [
        _summary("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:89",
                 launches["flash_attention"], t["flash_attention"]["float32"]),
        _summary("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:71",
                 launches["ssd_scan"], t["ssd_scan"]["float32"]),
        _summary("kv_pack", "src/repro_torch/csrc/kv_pack.cu",
                 "src/repro/kernels/kv_pack/kernel.py:29",
                 launches["kv_pack"], t["kv_pack"]["float32"]),
        _summary("kv_unpack", "src/repro_torch/csrc/kv_pack.cu",
                 "src/repro/kernels/kv_pack/kernel.py:52",
                 launches["kv_unpack"], t["kv_unpack"]["float32"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
