#!/usr/bin/env python3
"""Probe the SSD-scan and flash-attention kernels on one NVIDIA GPU.

    python3 kernel_probe.py build            # nvcc -Xptxas -v: registers, spills, SASS HGMMA
    python3 kernel_probe.py check float32    # SSD scan (and flash) against the plain versions
    python3 kernel_probe.py check bfloat16
    python3 kernel_probe.py time             # SSD and flash times, the SSD split by kernel
    python3 kernel_probe.py engine           # the engine's fp64 kernels and the padded shapes
    python3 kernel_probe.py drain            # the completion drain alone: checks, times, staging A/B
    python3 kernel_probe.py families         # the MoE and enc-dec serve phases, flash at their shapes
    python3 kernel_probe.py training         # the train and rl_update phases alone
    python3 kernel_probe.py sharded          # qwen3-moe f32 served, then the sharded and dryrun phases
    python3 kernel_probe.py lint             # the five libraries built, then the lint phase
    python3 kernel_probe.py ssm_step         # the Mamba2 decode-step kernels: checks, times, launches

A quicker loop than `chip_smoke.py` while a kernel is being changed: each
mode is its own process, so a kernel that faults in `check` leaves the
others able to run. `build` compiles into build/probe/ with the flags of
`repro_torch.kernels.build` plus `-Xptxas -v` and counts the `HGMMA`
instructions of each kernel in the library's SASS (cuobjdump). `check`
holds the SSD scan against `ssd_scan_ref` at `chip_smoke.py`'s SSD shapes
plus two odd ones (P = 40, N = 24, chunk 32 with an initial state; N = 100
with B/C rows 2N + 1 apart), and flash attention at qwen2-0.5b's shape.
`time` gives the CUDA-event time through the public wrapper and the
profiler's device time of each kernel, at the mamba2-370m and hymba-1.5b
serving shapes. `engine` checks the jitted engine core's two kernels and
the spray sim against their twins (the checks of `chip_smoke.py`'s
jit_core phase and the flap's 64 lanes), the padded flash head dims and the
SSD's reference shapes, times the three engine kernels once (the drain also
at 16 slots x 32, 256 and 1024 completions and at a fixed depth of 8), runs
the drain's staging A/B (`chip_smoke.py::drain_ab`: the path's call in place
on the mapped staging buffer against a copy in, launch and copy back) and
prices each piece of its call
(`drain_call_costs`), and times spray_sim at the
flap's 64 lanes with a lane a block and with two lanes a warp, in turns.
`families` runs `chip_smoke.py`'s phases for the MoE and enc-dec models
alone: flash attention checked and timed at qwen3-moe's and seamless-m4t's
prefill shapes, the qwen3-moe-235b-a22b (f32 depth 2, bf16 depth 4) and
seamless-m4t-medium serve phases with their profiles, and `moe_layer`.
`training` runs `chip_smoke.py`'s train phase (full-width qwen2-0.5b) and
its rl_update phase (the trained checkpoint through TENT to 16 ranks and a
flash prefill on it) alone. `sharded` serves qwen3-moe-235b-a22b in f32 at
depth 2 (`chip_smoke.py`'s serve phase), then runs its sharded phase on
that model under the host mesh and the dryrun phase. `lint` builds and
loads the five kernel libraries (`chip_smoke.py`'s env phase), then runs
its lint phase: tentlint --strict over the port's tree, the flags the rule
reads against those the libraries were built with, and a scenario under
the runtime sanitizer. `ssm_step` runs `chip_smoke.py`'s checks and timings
of the Mamba2 decode-step kernels at mamba2-370m's, granite-4.0-h-small's
and hymba-1.5b's decode widths in float32 and bfloat16, and counts the
launches of one eager mamba2-370m decode step without and with them.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

WGMMA_SOURCES = ("ssd_scan", "flash_attention")
# every source `build` compiles, with its library's own nvcc flags
SOURCES = {"ssd_scan": (), "flash_attention": (), "tent_core": ("--fmad=false",),
           "spray_sim": ("--fmad=false",), "ssm_step": ()}


def build() -> int:
    from chip_smoke import sass_hgmma
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc

    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        lib = out / f"{name}.so"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *SOURCES[name], "-Xptxas", "-v", "-o",
                               str(lib), str(CSRC / f"{name}.cu")], capture_output=True,
                              text=True)
        return name, proc, lib

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        results = list(pool.map(one, SOURCES))
    rc = 0
    for name, proc, lib in results:
        print(f"== {name}: nvcc exit {proc.returncode}")
        log = (proc.stdout + proc.stderr).splitlines()
        if proc.returncode:
            rc = 1
            print("\n".join(log[:80]))
            continue
        for line in log:
            if any(k in line for k in ("Compiling entry", "registers", "spill", "C7515", "warning")):
                print("  " + line.strip()[:240])
        if name in WGMMA_SOURCES:
            for func, n in sass_hgmma(lib).items():
                print(f"  HGMMA {n:4d} {func}")
    return rc


def check(dtype_name: str) -> int:
    import torch

    import chip_smoke as cs

    dtype = getattr(torch, dtype_name)
    cases = ([(cs.SSD_SERVE_SHAPE, {}), (cs.SSD_HYMBA_SHAPE, {})]
             + [(shape, {}) for shape in cs.SSD_TAIL_SHAPES + cs.SSD_SHORT_SHAPES]
             + [(cs.SSD_STATE_SHAPE, {"with_state": True}),
                (cs.SSD_MISALIGNED_SHAPE, {"bc_pad": cs.SSD_MISALIGNED_PAD}),
                ((1, 77, 3, 40, 24, 32), {"with_state": True}),
                ((1, 130, 2, 64, 100, 128), {"bc_pad": 1})])
    bad = 0
    for shape, kw in cases:
        try:
            case, _ = cs._check_ssd(shape, dtype, seed=5, **kw)
            print("OK ", shape, kw, f"y {case['y_max_abs_err']:.3g} state "
                  f"{case['state_max_abs_err']:.3g}", flush=True)
        except AssertionError as err:
            bad += 1
            print("BAD", shape, kw, str(err)[:400], flush=True)
    try:
        case, _ = cs._check_case(cs.SERVE_SHAPE, dtype, 0, seed=1)
        print("OK  flash", cs.SERVE_SHAPE, case["max_abs_err"])
    except AssertionError as err:
        bad += 1
        print("BAD flash", err)
    return 1 if bad else 0


def time_kernels() -> int:
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi())
    for dtype in (torch.float32, torch.bfloat16):
        for shape in (cs.SSD_SERVE_SHAPE, cs.SSD_HYMBA_SHAPE):
            x, a, Bm, Cm, _ = cs._ssd_inputs(shape, dtype, 4)
            fn = lambda: cs.ssd_chunked(x, a, Bm, Cm, chunk=shape[5])  # noqa: E731
            print(json.dumps({"shape": shape, "dtype": str(dtype), "ms": cs.cuda_ms(fn),
                              "device_ms": cs.device_ms_by_kernel(fn),
                              "bound": cs.ssd_bound(*shape, dtype)}), flush=True)
        q, k, v = cs._qkv(cs.SERVE_SHAPE, dtype, 1)
        fn = lambda: cs.flash_attention(q, k, v, causal=True)  # noqa: E731
        print(json.dumps({"flash": str(dtype), "ms": cs.cuda_ms(fn),
                          "device_ms": cs.device_ms(fn, cs.FLASH_NAME)}), flush=True)
    return 0


def drain_call_costs(n_links=63, m=8, iters=2000) -> dict:
    """Host microseconds a call of each piece of the drain's call at one
    shape (host clock over `iters` calls): the device and stream lookups, a
    buffer check, the bare ctypes launch (unsynchronised), the public
    wrapper (unsynchronised), the bare staged C entry (launch in place on
    the mapped staging buffer and wait; with m = 0 the launch-and-wait
    floor) and the `StagedDrain` call around it; and the profiler's device
    time of the kernel on the mapped buffer."""
    import time

    import torch

    import chip_smoke as cs

    _, ps, pm, inputs = cs._drain_inputs(n_links, m)
    card = torch.tensor(inputs, device="cuda")
    state, batch = card[:8 * ps], card[8 * ps:]
    lib = cs.tc_kernel.load()
    stream = torch.cuda.current_stream().cuda_stream
    staging = cs.tc_ops.Staging("cuda")
    n = 8 * ps + 4 * pm
    staging.host(n)[1][:] = inputs
    call = staging.drain(n)
    sp, bp = state.data_ptr(), batch.data_ptr()

    def per_call(fn, sync=False):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if sync:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / iters

    out = {
        "current_device_us": per_call(torch.cuda.current_device),
        "current_stream_us": per_call(lambda: torch.cuda.current_stream(0).cuda_stream),
        "check_us": per_call(lambda: cs.tc_kernel._check(state, 8 * ps, "state")),
        "bare_launch_us": per_call(lambda: lib.tent_on_complete_many_launch(
            sp, ps, bp, pm, m, stream), sync=True),
        "public_wrapper_us": per_call(lambda: cs.tc_kernel.complete_many(state, batch, ps, pm, m),
                                      sync=True),
        "bare_staged_m0_us": per_call(lambda: call._fn(call._dev, ps, pm, 0, call._stream)),
        "bare_staged_us": per_call(lambda: call._fn(call._dev, ps, pm, m, call._stream)),
        "staged_call_us": per_call(lambda: call(ps, pm, m)),
        "mapped_kernel_device_ms": cs.device_ms(lambda: call(ps, pm, m),
                                                "tent_on_complete_many")[0],
    }
    print("drain call costs", json.dumps(out), flush=True)
    return out


def drain() -> int:
    """The drain alone: its checks, the engagement transfer, its timings,
    its staging A/B and the price of each piece of its call."""
    import chip_smoke as cs

    print(cs.nvidia_smi(), flush=True)
    cs.tc_kernel.load()
    checks = cs.jit_kernel_checks()
    print("OK  engine kernels", json.dumps({k: v for k, v in checks.items()
                                            if "drain" in k or "scratch" in k}), flush=True)
    with cs.forced_crossover():
        cs.reset_launches()
        print("engage", json.dumps(cs.engage_transfer()), json.dumps(cs.read_launches()),
              flush=True)
    print("timing", json.dumps({"drain": cs.drain_timing(63, 8),
                                "drain_16": {str(m): cs.drain_timing(16, m)
                                             for m in cs.JIT_BUCKETS},
                                "drain_fixed_depth": cs.drain_fixed_depth()}), flush=True)
    cs.drain_ab(63, 8)
    drain_call_costs()
    return 0


def engine() -> int:
    import torch

    import chip_smoke as cs

    print(cs.nvidia_smi(), flush=True)
    for mod in cs.LIBRARIES:
        mod.load()
    bad = 0
    for label, call in (
            ("flash padded head dims", lambda: [cs._check_case(s, dt, 0, seed=2)[0]["max_abs_err"]
                                                for s in cs.PADDED_HEAD_SHAPES
                                                for dt in (torch.float32, torch.bfloat16)]),
            ("ssd reference shapes", lambda: [cs._check_ssd(s, dt, seed=8)[0]["max_abs_err"]
                                              for s in cs.SSD_REF_SHAPES
                                              for dt in (torch.float32, torch.bfloat16)]),
            ("ssd mixed types", lambda: [cs._check_ssd_mixed(s, seed=9)["max_abs_err"]
                                         for s in cs.SSD_REF_SHAPES]),
            ("engine kernels", cs.jit_kernel_checks)):
        try:
            print("OK ", label, json.dumps(call()), flush=True)
        except AssertionError as err:
            bad += 1
            print("BAD", label, str(err)[:2000], flush=True)
    with cs.forced_crossover():
        cs.reset_launches()
        print("engage", json.dumps(cs.engage_transfer()), json.dumps(cs.read_launches()),
              flush=True)
    sweep = cs.MonteCarloSweep(cs.get("single_rail_flap"), n_seeds=cs.MC_SEEDS,
                               fault_jitter=cs.MC_JITTER)
    p = sweep.program
    draws = cs.stack_draws(p, cs.MC_SEEDS, base_seed=sweep.base_seed)
    for pol in cs.SWEEP_POLICIES:
        kern, k_ms = cs.wall_ms(lambda: cs.spray_sim(p, draws, policy=pol,
                                                      fault_jitter=cs.MC_JITTER, device="cuda"))
        plain, p_ms = cs.wall_ms(lambda: cs.spray_sim_ref(p, draws, policy=pol,
                                                         fault_jitter=cs.MC_JITTER,
                                                         device="cuda"))
        lane0 = cs.simulate_spray_ref(p, {k: v[0] for k, v in draws.items()}, policy=pol,
                                      fault_jitter=cs.MC_JITTER)
        equal = torch.equal(kern, plain) and tuple(kern[0].tolist()) == lane0
        bad += not equal
        diff = (kern != plain).any(1).nonzero()[:, 0].tolist()
        print("OK " if equal else "BAD", "spray_sim", pol, json.dumps(
            {"kernel_wall_ms": k_ms, "plain_wall_ms": p_ms, "lanes_differ": diff[:10],
             "lane0_kernel": kern[0].tolist(), "lane0_numpy": lane0}), flush=True)
    print("timing", json.dumps({"choose": cs.choose_timing(8, 64),
                                "drain": cs.drain_timing(63, 8),
                                "drain_16": {str(m): cs.drain_timing(16, m)
                                             for m in cs.JIT_BUCKETS},
                                "drain_fixed_depth": cs.drain_fixed_depth()}), flush=True)
    cs.drain_ab(63, 8)
    drain_call_costs()
    card = [torch.from_numpy(draws[k]).cuda() for k in ("uf", "us", "ud", "jm")]
    fn = lambda: cs.sim_kernel.spray_sim(p, *card, round_robin=False,  # noqa: E731
                                         fault_jitter=cs.MC_JITTER)
    ms = cs.cuda_ms(fn, iters=3, warmup=1)
    plan = cs.sim_kernel.plan_for(p, cs.MC_SEEDS, cs.sim_kernel._n_sms(card[0].device))
    print("spray_sim ms", ms, "us_per_step", ms * 1e3 / (p.rounds * p.wave),
          "device", cs.device_ms(fn, "spray_sim", 2), "bound", cs.sim_bound(p, cs.MC_SEEDS),
          "plan", plan, flush=True)
    # the launch plan's choice at 64 lanes, timed in turns: a lane a block
    # (its warp to itself) against two lanes a warp, the same lanes
    packed = dataclasses.replace(plan, groups_per_block=2, blocks=-(-cs.MC_SEEDS // 2))
    plan_for = cs.sim_kernel.plan_for
    alone = fn().clone()
    turns = {}
    for name in ("alone", "packed", "packed", "alone"):
        cs.sim_kernel.plan_for = (lambda *a, **k: packed) if name == "packed" else plan_for
        try:
            equal = torch.equal(fn(), alone)
            turns.setdefault(name, []).append(cs.cuda_ms(fn, iters=3, warmup=1))
        finally:
            cs.sim_kernel.plan_for = plan_for
        bad += not equal
    print("spray_sim lanes a warp", json.dumps(turns), flush=True)
    return 1 if bad else 0


def families() -> int:
    import torch

    import chip_smoke as cs

    cs.phase_env()
    for shape in (cs.QWEN3_MOE_FLASH_SHAPE, cs.SEAMLESS_FLASH_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            case, _ = cs._check_case(shape, dtype, 0, seed=1)
            print("flash", json.dumps(cs._flash_timing(shape, dtype, case)), flush=True)
    for entry in cs.SERVES:
        if entry[0] in (cs.MOE_ARCH, "seamless-m4t-medium"):
            serve, model = cs.phase_serve(*entry)
            cs.phase_profile(*model)
            del serve, model
            torch.cuda.empty_cache()
    cs.phase_moe_layer()
    return 0


def training() -> int:
    import torch

    import chip_smoke as cs

    cs.phase_env()
    _, cfg, params = cs.phase_train()
    torch.cuda.empty_cache()
    cs.phase_rl_update(cfg, params)
    return 0


def sharded() -> int:
    import torch

    import chip_smoke as cs

    cs.phase_env()
    entry = next(e for e in cs.SERVES if e[0] == cs.SHARDED_ARCH and e[4] == torch.float32)
    _, model = cs.phase_serve(*entry)
    cs.phase_sharded(*model[:3])
    del model
    cs.phase_dryrun()
    return 0


def lint() -> int:
    import chip_smoke as cs

    cs.phase_env()
    cs.phase_lint()
    return 0


def ssm_step() -> int:
    import torch

    import chip_smoke as cs

    print(cs.nvidia_smi(), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for key, shape in cs.SSM_STEP_SHAPES.items():
            case = cs._check_ssm_step(shape, dtype, seed=13)
            timing = cs._ssm_step_timing(shape, dtype, case)
            print("ssm_step", key, json.dumps({**case, **timing}), flush=True)
    print("eager_decode_step", json.dumps(cs._eager_step_launches()), flush=True)
    return 0


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "build":
        sys.exit(build())
    if mode == "check" and len(sys.argv) == 3:
        sys.exit(check(sys.argv[2]))
    if mode == "time":
        sys.exit(time_kernels())
    if mode == "engine":
        sys.exit(engine())
    if mode == "drain":
        sys.exit(drain())
    if mode == "families":
        sys.exit(families())
    if mode == "training":
        sys.exit(training())
    if mode == "sharded":
        sys.exit(sharded())
    if mode == "lint":
        sys.exit(lint())
    if mode == "ssm_step":
        sys.exit(ssm_step())
    print(__doc__, file=sys.stderr)
    sys.exit(2)
