"""The engine's CUDA kernels (`csrc/spray_sim.cu`, `csrc/tent_core.cu`)
compiled for the CPU and held against the numpy twins.

The card alone runs the kernels, and a fault in their warp-level logic
(the group reductions, ballots and ranks, the per-rail lists) otherwise
shows only there. Here each source is compiled with g++ against a small
header that emulates the CUDA features the kernels use: a block at a
time, its threads as fibers on one OS thread (ucontext), each running
until it reaches a collective (`__shfl_*_sync`, `__ballot_sync`,
`__reduce_min_sync`, `__syncwarp`, `__syncthreads`) that the other
threads its mask names have not reached yet; shared memory is one
process-wide buffer; `cp.async` is a plain copy; the `_rn` intrinsics are
plain IEEE double operations, each rounded on its own (volatile, so the
compiler cannot contract them). A kernel that diverged from its
collectives would hang, so each check runs in a subprocess with a time
limit. The lanes must equal the numpy twins (the port's and the
reference's) bit for bit, as on the card. This checks the kernels' logic,
not Hopper's timing or memory model.
"""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"

HEADER = r"""
#pragma once
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x)
#define __restrict__
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline dim3 threadIdx, blockIdx, blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// host and card share one memory: a mapped pointer is the host pointer itself
inline cudaError_t cudaStreamSynchronize(cudaStream_t) { return cudaSuccess; }
inline cudaError_t cudaHostGetDevicePointer(void** dev, void* host, unsigned) {
  *dev = host;
  return cudaSuccess;
}
inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
inline double __dsub_rn(double a, double b) { volatile double r = a - b; return r; }
inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
inline double __ddiv_rn(double a, double b) { volatile double r = a / b; return r; }
inline long long __double_as_longlong(double v) { long long u; std::memcpy(&u, &v, 8); return u; }
inline double __longlong_as_double(long long u) { double v; std::memcpy(&v, &u, 8); return v; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
using std::isfinite;
using std::isinf;
namespace emu {
// a block's threads are fibers on one OS thread, switched at collectives
struct Fiber { ucontext_t ctx; std::unique_ptr<char[]> stack; unsigned tid; bool done; };
inline std::vector<Fiber> fibers;
inline int cur;
inline ucontext_t sched;
inline std::function<void()> body;
inline void yield() { swapcontext(&fibers[cur].ctx, &sched); }
inline void entry() {
  body();
  fibers[cur].done = true;
}
struct Warp { uint64_t slot[32]; int pred[32]; };
inline Warp warps[32];
struct Bar { int count = 0; unsigned gen = 0; };
inline std::map<std::pair<int, unsigned>, Bar> bars;
inline int lane() { return threadIdx.x & 31; }
inline Warp& warp() { return warps[threadIdx.x >> 5]; }
// a barrier of the threads of this thread's warp that `mask` names
inline void sync(unsigned mask) {
  Bar& b = bars[{(int)(threadIdx.x >> 5), mask}];
  const unsigned gen = b.gen;
  if (++b.count == __builtin_popcount(mask)) {
    b.count = 0;
    ++b.gen;
    return;
  }
  while (b.gen == gen) yield();
}
template <class T> T exchange(unsigned mask, T v, int src) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  warp().slot[lane()] = u;
  sync(mask);
  const uint64_t r = warp().slot[src];
  sync(mask);
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
}  // namespace emu
inline void __syncwarp(unsigned mask = 0xffffffffu) { emu::sync(mask); }
template <class T> T __shfl_xor_sync(unsigned mask, T v, int o, int w = 32) {
  return emu::exchange(mask, v, emu::lane() ^ o);
}
template <class T> T __shfl_sync(unsigned mask, T v, int s, int w = 32) {
  return emu::exchange(mask, v, (emu::lane() & ~(w - 1)) + s);
}
inline unsigned __ballot_sync(unsigned mask, int p) {
  emu::warp().pred[emu::lane()] = p != 0;
  emu::sync(mask);
  unsigned b = 0;
  for (int i = 0; i < 32; ++i)
    if ((mask >> i) & 1 && emu::warp().pred[i]) b |= 1u << i;
  emu::sync(mask);
  return b;
}
// the lanes of `mask` whose value equals this lane's
template <class T> unsigned __match_any_sync(unsigned mask, T v) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  emu::warp().slot[emu::lane()] = u;
  emu::sync(mask);
  unsigned g = 0;
  for (int i = 0; i < 32; ++i)
    if ((mask >> i) & 1 && emu::warp().slot[i] == u) g |= 1u << i;
  emu::sync(mask);
  return g;
}
inline unsigned __reduce_min_sync(unsigned mask, unsigned v) {
  emu::warp().slot[emu::lane()] = v;
  emu::sync(mask);
  unsigned m = 0xffffffffu;
  for (int i = 0; i < 32; ++i)
    if ((mask >> i) & 1) m = std::min(m, (unsigned)emu::warp().slot[i]);
  emu::sync(mask);
  return m;
}
// every thread of the block (the block kernels' __syncthreads)
inline void __syncthreads() {
  static int count = 0;
  static unsigned gen = 0;
  const unsigned g = gen;
  if (++count == (int)blockDim.x) {
    count = 0;
    ++gen;
    return;
  }
  while (gen == g) emu::yield();
}
alignas(16) inline unsigned char emu_smem[1 << 22];
alignas(16) inline double emu_sh[1 << 16];
// a launch runs its blocks one after another; a block runs its threads as
// fibers, each until it meets a collective the others have not reached
template <class F, class... A>
void emu_launch(F f, int blocks, int threads, size_t, cudaStream_t, A... args) {
  blockDim.x = threads;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    emu::bars.clear();
    emu::body = [&] { f(args...); };
    emu::fibers.clear();
    emu::fibers.resize(threads);
    for (int t = 0; t < threads; ++t) {
      emu::Fiber& fb = emu::fibers[t];
      fb.tid = t;
      fb.done = false;
      fb.stack.reset(new char[1 << 18]);
      getcontext(&fb.ctx);
      fb.ctx.uc_stack.ss_sp = fb.stack.get();
      fb.ctx.uc_stack.ss_size = 1 << 18;
      fb.ctx.uc_link = &emu::sched;
      makecontext(&fb.ctx, emu::entry, 0);
    }
    for (bool live = true; live;) {
      live = false;
      for (int t = 0; t < threads; ++t) {
        if (emu::fibers[t].done) continue;
        live = true;
        emu::cur = t;
        threadIdx.x = t;
        swapcontext(&emu::sched, &emu::fibers[t].ctx);
      }
    }
  }
}
"""


def _for_cpu(source: str) -> str:
    """A kernel source rewritten for the emulation: launches through
    emu_launch, cp.async as a copy, shared memory in the emulation's
    buffers (a kernel's own `__shared__` arrays become statics: one block
    runs at a time)."""
    s = re.sub(r"(\w+)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ", source)
    s = re.sub(r'asm volatile\("cp\.async\.cg[^\n]*', "std::memcpy(dst, src, 16); (void)s;", s)
    s = re.sub(r'asm volatile\("cp\.async[^\n]*', ";", s)
    s = re.sub(r"extern __shared__[^;]*smem\[\];", "unsigned char* smem = emu_smem;", s)
    s = re.sub(r"extern __shared__ double sh\[\];", "double* sh = emu_sh;", s)
    return s.replace("__shared__ ", "static ")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The two engine libraries built for the CPU: {name: path}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CPU emulation of the CUDA kernels")
    out = tmp_path_factory.mktemp("cuda_emulation")
    (out / "cuda_runtime.h").write_text(HEADER)
    libs = {}
    for name in ("spray_sim", "tent_core"):
        src = out / f"{name}.cpp"
        src.write_text('#include "cuda_runtime.h"\n' + _for_cpu((CSRC / f"{name}.cu").read_text()))
        lib = out / f"lib{name}.so"
        proc = subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                               "-shared", "-w", f"-I{out}", "-o", str(lib), str(src)],
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        libs[name] = str(lib)
    return libs


# Run in a subprocess: the emulated launch, the numpy twins, the verdict.
SIM_CHECK = r"""
import ctypes, dataclasses, json, math, sys
import numpy as np
from repro.core.jit_core import simulate_spray_ref as ref_simulate
from repro_torch.core.jit_core import simulate_spray_ref, stack_draws
from repro_torch.kernels.spray_sim import kernel
from repro_torch.scenarios import get
from repro_torch.scenarios.sweep import compile_spray_program

job = json.loads(sys.argv[1])
lib = ctypes.CDLL(job["lib"])
lib.spray_sim_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                                 + [ctypes.c_double] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
lib.spray_sim_group_bytes.argtypes = [ctypes.c_int] * 6
lib.spray_sim_group_bytes.restype = ctypes.c_longlong
p = compile_spray_program(get(job["name"]), rounds=job["rounds"])
if job["rails"]:  # the program's rails repeated, bandwidths spread apart
    D = job["rails"]
    kw = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, np.ndarray) and v.shape[:1] == (p.n_rails,):
            kw[f.name] = np.resize(v, (D,) + v.shape[1:])
    spread = 1 + 0.01 * np.arange(D)
    kw["bw_score"], kw["bw_src"] = kw["bw_score"] * spread, kw["bw_src"] * spread
    p = dataclasses.replace(p, n_rails=D, **kw)
n, fj = job["lanes"], job["fault_jitter"]
draws = stack_draws(p, n, base_seed=3)
D, R, W = p.n_rails, p.rounds, p.wave
Kf, Ks, Kd = p.fail_start.shape[1], p.degs_start.shape[1], p.degd_start.shape[1]
plan = kernel.launch_plan(n, D, R, W, Kf, Ks, Kd)
if job["packed"]:  # every lane in one block: half-warp groups share warps
    plan = dataclasses.replace(plan, groups_per_block=n, blocks=1)
assert lib.spray_sim_group_bytes(D, W, Kf, Ks, Kd, int(plan.fault_cap == 0)) == plan.group_bytes
prog = kernel.program_constants(p)
arrs = [np.ascontiguousarray(draws[k]) for k in ("uf", "us", "ud", "jm")]
result = {"plan": dataclasses.asdict(plan), "bad": []}
for policy in ("tent", "round_robin"):
    out = np.full((n, 5), np.nan)
    err = lib.spray_sim_launch(
        prog.ctypes.data, *(a.ctypes.data for a in arrs), out.ctypes.data, n, D, R, W, Kf, Ks,
        Kd, int(policy == "round_robin"), float(p.length), float(p.detect), float(p.gamma),
        math.inf if fj == 0 else 1.0 / fj, plan.G, plan.fault_cap, plan.degrade_cap,
        plan.groups_per_block, plan.group_bytes, None)
    assert err == 0, err
    for i in range(n):
        lane = {k: v[i] for k, v in draws.items()}
        want = simulate_spray_ref(p, lane, policy=policy, fault_jitter=fj)
        if tuple(out[i].tolist()) != want or ref_simulate(p, lane, policy=policy,
                                                          fault_jitter=fj) != want:
            result["bad"].append([policy, i, out[i].tolist(), list(want)])
    result[policy] = out.tolist()
print(json.dumps(result))
"""

CHOOSE_CHECK = r"""
import ctypes, json, sys
import numpy as np
from repro.core.scheduler import tent_choose_wave
from repro_torch.core.jit_core import _bucket

job = json.loads(sys.argv[1])
lib = ctypes.CDLL(job["lib"])
lib.tent_choose_wave_padded_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
rng = np.random.default_rng(job["seed"])
bad, cases = [], 0
for n_c in job["candidates"]:
    for n_s in job["slices"]:
        for all_ex in (False, True):
            q = rng.integers(0, 1 << 28, size=n_c)
            gl, gr = rng.uniform(0.0, 1e7, size=n_c), rng.uniform(0.0, 1e7, size=n_c)
            bw = rng.choice([1e9, 25e9, 100e9], size=n_c)
            b0, b1 = rng.uniform(0.0, 1e-3, size=n_c), rng.uniform(0.05, 10.0, size=n_c)
            pen = rng.choice([1.0, 1.0, 1.5, np.inf], size=n_c)
            ex = np.ones(n_c, dtype=bool) if all_ex else rng.random(n_c) < 0.35
            lengths = rng.integers(1, 1 << 20, size=n_s)
            rr, gamma = int(rng.integers(0, 1000)) + job["rr_base"], float(rng.choice([0.0, 0.05, 0.2]))
            want = tent_choose_wave(q, gl, gr, bw, b0, b1, pen, ex, lengths, rr, gamma=gamma)
            pc, ps = _bucket(n_c), _bucket(n_s)

            def pad(a, m, fill):
                out = np.full(m, fill, dtype=np.float64)
                out[:len(a)] = a
                return out

            inp = np.concatenate([pad(q, pc, 0.0), pad(gl, pc, 0.0), pad(gr, pc, 0.0),
                                  pad(bw, pc, 1.0), pad(b0, pc, 0.0), pad(b1, pc, 1.0),
                                  pad(pen, pc, np.inf), pad(ex, pc, 1.0), pad(lengths, ps, 0.0),
                                  pad(np.ones(n_s), ps, 0.0), [float(rr), gamma]])
            out = np.full(2 * ps + pc + 1, np.nan)
            assert lib.tent_choose_wave_padded_launch(inp.ctypes.data, out.ctypes.data, pc, ps,
                                                      None) == 0
            got = (out[:n_s], out[ps:ps + n_s].astype(np.int64),
                   out[2 * ps:2 * ps + n_c].astype(np.int64), int(out[2 * ps + pc]))
            cases += 1
            if not all(np.array_equal(np.asarray(w), np.asarray(g)) for w, g in zip(want, got)):
                bad.append([n_c, n_s, all_ex])
print(json.dumps({"cases": cases, "bad": bad}))
"""


DRAIN_CHECK = r"""
import ctypes, json, sys
import numpy as np
import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch.core.jit_core import _bucket

STATE = ("beta0_arr", "beta1_arr", "queued_arr", "ewma_service_arr", "completions_arr")
job = json.loads(sys.argv[1])
lib = ctypes.CDLL(job["lib"])
lib.tent_on_complete_many_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
lib.tent_on_complete_many_staged.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]


def store(module, seed, n_links):
    rng = np.random.default_rng(seed)
    st = module.TelemetryStore()
    for i in range(n_links):
        tl = st.ensure(module.LinkDesc(link_id=i, node=0, link_class=module.LinkClass.RDMA,
                                       index=i, numa=0, bandwidth=float(rng.choice([25e9, 1e9])),
                                       base_latency=5e-6))
        tl.queued_bytes = int(rng.integers(0, 1 << 30))
        tl.beta0 = float(rng.uniform(0.0, 1e-2))
        tl.beta1 = float(rng.uniform(0.05, 50.0))
        tl.ewma_service_time = float(rng.uniform(0.0, 1.0))
    return st


rng = np.random.default_rng(11)
bad, cases = [], []
for label, n_links, m, pm, one_slot in job["cases"]:
    seed = int(rng.integers(0, 1 << 30))
    slots = (np.full(m, one_slot) if one_slot is not None else rng.integers(0, n_links, size=m))
    lengths = rng.integers(0, 1 << 22, size=m)
    queued_at = rng.integers(0, 1 << 24, size=m)
    zero = rng.random(m) < 0.1  # x = 0: beta1 keeps its value
    lengths[zero], queued_at[zero] = 0, 0
    t_obs = rng.uniform(0.0, 5.0, size=m)
    a, b = store(ref_core, seed, n_links), store(port_core, seed, n_links)
    a.on_complete_many(slots, lengths, queued_at, t_obs)
    b.on_complete_many(slots, lengths, queued_at, t_obs)
    ps = _bucket(n_links + 1)
    state = np.concatenate(store(port_core, seed, n_links).gather_complete_state(ps))
    gathered = state.copy()
    # the columns hold garbage past m: the kernel must not read them
    cols = np.full((4, pm), np.nan)
    cols[:, :m] = slots, lengths, queued_at, t_obs
    buf = np.concatenate([state, cols.ravel()])
    if job["entry"] == "launch":
        err = lib.tent_on_complete_many_launch(buf.ctypes.data, ps, buf[8 * ps:].ctypes.data, pm,
                                               m, None)
    else:  # the staging buffer read and written in place
        err = lib.tent_on_complete_many_staged(buf.ctypes.data, ps, pm, m, None)
    assert err == 0, err
    out = buf[:5 * ps].reshape(5, ps)
    same = all(np.array_equal(out[k, :n_links], getattr(a, name)[:n_links].astype(np.float64))
               and np.array_equal(out[k, :n_links], getattr(b, name)[:n_links].astype(np.float64))
               for k, name in enumerate(STATE))
    scratch = np.array_equal(out[:, n_links:], gathered[:5 * ps].reshape(5, ps)[:, n_links:])
    cases.append([label, ps, pm, m])
    if not (same and scratch):
        bad.append([label, same, scratch])
print(json.dumps({"cases": cases, "bad": bad}))
"""

# (label, links, m live, pm, the one slot every entry names or None)
DRAIN_CASES = [
    ("repeated slots", 5, 37, 64, None),
    ("one slot takes the batch", 4, 50, 64, 2),
    ("padded tail", 3, 9, 16, None),
    ("ps above one block", 300, 700, 1024, None),
    ("batch above one tile", 6, 2500, 4096, None),
    ("m = 1", 7, 1, 8, None),
    ("m = pm", 7, 64, 64, None),
    ("odd m", 2, 33, 64, None),
]

def _run(code: str, job: dict) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(job)], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("name,rounds,rails,packed,fault_jitter,caps", [
    # 6 fault windows a rail (the 8-window register variant): flaps that
    # fail slices, retries and healing within 24 rounds
    ("flap_storm", 24, 0, False, 0.25, (8, 1)),
    # the same lanes with two half-warp groups in one warp
    ("flap_storm", 24, 0, True, 0.25, (8, 1)),
    # 20 rails: a warp a lane, every window in shared memory
    ("flap_storm", 24, 20, False, 0.25, (0, 0)),
    # 40 rails: two rails a thread
    ("flap_storm", 6, 40, False, 0.25, (0, 0)),
    # 2 fault / 1 degradation windows a rail, the exact declared schedule
    ("single_rail_flap", 8, 0, False, 0.0, (2, 1)),
    # 3 degradation windows a rail
    ("degrade_recover_ramp", 8, 0, False, 0.25, (2, 3)),
    # 73 degradation windows a rail: all windows in shared memory
    ("multi_tenant_contention", 1, 0, False, 0.25, (0, 0)),
    # one rail
    ("disagg_prefill_decode", 8, 0, False, 0.25, (2, 1)),
])
def test_spray_sim_lanes_equal_the_numpy_twins(emulated, name, rounds, rails, packed,
                                               fault_jitter, caps):
    res = _run(SIM_CHECK, {"lib": emulated["spray_sim"], "name": name, "rounds": rounds,
                           "rails": rails, "packed": packed, "lanes": 2,
                           "fault_jitter": fault_jitter})
    assert (res["plan"]["fault_cap"], res["plan"]["degrade_cap"]) == caps
    assert res["plan"]["G"] == (16 if not rails or rails < 16 else 32)
    assert not res["bad"], res["bad"][:2]
    if (name, rounds, rails) == ("flap_storm", 24, 0):  # the flaps took slices and healed
        for policy, lost_some in (("tent", True), ("round_robin", False)):
            lanes = res[policy]
            assert all(lane[1] >= 0 for lane in lanes)
            assert any(lane[3] > 0 for lane in lanes) == lost_some


@pytest.mark.parametrize("rr_base", [0, (1 << 32) - 500])
def test_wave_chooser_equals_the_numpy_chooser(emulated, rr_base):
    """Both chooser kernels across their seam (1-32 candidates on the warp
    kernel, 33 and 40 on the block kernel), with a round-robin counter
    inside and across 32 bits."""
    res = _run(CHOOSE_CHECK, {"lib": emulated["tent_core"], "seed": 5, "rr_base": rr_base,
                              "candidates": [1, 2, 8, 31, 32, 33, 40],
                              "slices": [1, 31, 33, 64]})
    assert res["cases"] == 56 and not res["bad"], res["bad"][:5]


@pytest.mark.parametrize("entry", ["launch", "staged"])
def test_drain_equals_the_numpy_store(emulated, entry):
    """The drain kernel's rows 0..n-1 bit-equal to the reference's and the
    port's numpy stores, and the scratch row n and the inert rows past it
    as gathered, on the live entries only (the tail past m is NaN)."""
    res = _run(DRAIN_CHECK, {"lib": emulated["tent_core"], "entry": entry, "cases": DRAIN_CASES})
    assert len(res["cases"]) == len(DRAIN_CASES) and not res["bad"], res["bad"]
    assert {(ps, pm) for _, ps, pm, _ in res["cases"]} >= {(512, 1024), (8, 4096)}
