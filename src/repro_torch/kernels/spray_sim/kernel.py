"""The fused Monte Carlo spray sim on Hopper: the ctypes binding of
csrc/spray_sim.cu.

Replaces the reference's fused `lax.scan` program
(`repro/core/jit_core.py::_build_sim`, vmapped over seeds by
`spray_sweep`), bit-exact with the numpy twin `simulate_spray_ref`: a
group of G threads runs each seed lane, its rails across the group.

Bound on an H100 SXM: the draws are read once (the service-jitter
multipliers dominate: rounds x wave x 2 doubles a lane) and the fp64 work
is some tens of operations per rail per slice, far below 3.35 TB/s and
34 TFLOP/s. What sets the time is each lane's chain of rounds x wave
dependent slice steps, so the kernel shortens the step (the rails scored
in parallel, shuffle and ballot reductions, no device memory on the step)
and `launch_plan` spreads the lanes over the SMs.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..build import load_library
from .ref import spray_sim_ref

#: Entry point -> its plain version; a (twin, reason) pair waives the match
#: of parameter names (tentlint's twin-drift rule reads this).
__torch_twins__ = {"spray_sim": (
    spray_sim_ref,
    "the launch takes the draws split into four card tensors and the policy as a "
    "round_robin flag; the twin takes the draws dict, the policy name and a device")}

#: Kernel launches since the count was last set to 0.
launches = 0

#: nvcc flags of this library: no multiply-add contraction, so every
#: product and sum rounds on its own as the numpy twin's do.
EXTRA_FLAGS = ("--fmad=false",)
MAX_RAILS = 62
#: Shared memory a block may hold on sm_90 (227 KB, opted into at launch),
#: and the most threads the kernel takes a block.
SMEM_PER_BLOCK = 232448
MAX_BLOCK = 256
#: Windows a rail keeps in registers in the kernel's register variants
#: (fault, degradation); a program with more keeps them in shared memory.
FAULT_CAPS = (2, 8)
DEGRADE_CAPS = (1, 3)
#: Lanes a SM up to which each lane gets a block (so a warp) of its own.
LANES_ALONE = 8

_lib = None


def load() -> ctypes.CDLL:
    """Build (on first use) and load the kernel's library."""
    global _lib
    if _lib is None:
        lib = load_library("spray_sim", ["spray_sim.cu"], extra_flags=EXTRA_FLAGS)
        lib.spray_sim_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_double] * 4
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.spray_sim_launch.restype = ctypes.c_int
        lib.spray_sim_group_bytes.argtypes = [ctypes.c_int] * 6
        lib.spray_sim_group_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def group_smem_bytes(D: int, W: int, Kf: int, Ks: int, Kd: int, win_smem: bool) -> int:
    """Shared memory of one seed lane's group (the source's `Layout`): the
    round's service multipliers twice (double-buffered) and its slice
    records with their rails' lists, 56 * W bytes, and every rail's
    jittered windows when they do not fit its registers (`win_smem`)."""
    doubles = 6 * W + (3 * D * (Kf + Ks + Kd) if win_smem else 0)
    return (8 * doubles + 4 * 2 * W + 15) // 16 * 16


@dataclass(frozen=True)
class SimPlan:
    """How the kernel runs one program: G threads a lane (`rails_per_thread`
    rails each), windows in registers up to `fault_cap` / `degrade_cap` a
    rail (0: in shared memory), `groups_per_block` lanes a block over
    `blocks` blocks, `group_bytes` of shared memory a lane."""
    G: int
    rails_per_thread: int
    fault_cap: int
    degrade_cap: int
    group_bytes: int
    groups_per_block: int
    blocks: int

    @property
    def threads_per_block(self) -> int:
        return self.G * self.groups_per_block

    @property
    def smem_per_block(self) -> int:
        return self.group_bytes * self.groups_per_block


def launch_plan(n_lanes: int, D: int, R: int, W: int, Kf: int, Ks: int, Kd: int,
                n_sms: int = 132) -> SimPlan:
    """The kernel's launch for `n_lanes` lanes of a program with D rails, R
    rounds of W slices and Kf / Ks / Kd windows a rail, on a card of `n_sms`
    SMs. Raises ValueError for a program the kernel does not take: more
    rails than MAX_RAILS, a chain too long for its 32-bit round-robin
    counter, or a lane whose shared memory does not fit a block."""
    if not 1 <= D <= MAX_RAILS:
        raise ValueError(f"spray_sim takes 1 to {MAX_RAILS} rails, got {D}")
    if n_lanes < 1 or min(R, W, Kf, Ks, Kd) < 0:
        raise ValueError(f"spray_sim: bad sizes n={n_lanes} R={R} W={W} K={Kf, Ks, Kd}")
    if 2 * R * W >= 2 ** 31:
        raise ValueError(f"spray_sim: {R} rounds of {W} slices overflow its slice counter")
    G = 16 if D + 1 <= 16 else 32
    regs = G == 16 and Kf <= FAULT_CAPS[-1] and max(Ks, Kd) <= DEGRADE_CAPS[-1]
    fault_cap = min(c for c in FAULT_CAPS if Kf <= c) if regs else 0
    degrade_cap = min(c for c in DEGRADE_CAPS if max(Ks, Kd) <= c) if regs else 0
    group_bytes = group_smem_bytes(D, W, Kf, Ks, Kd, not regs)
    fit = SMEM_PER_BLOCK // group_bytes
    if fit < 1:
        raise ValueError(
            f"spray_sim: a lane of this program (D={D}, W={W}, K={Kf, Ks, Kd}) needs "
            f"{group_bytes} bytes of shared memory, more than a block's {SMEM_PER_BLOCK}")
    # Lanes a block. A lane runs fastest with its warp to itself: two
    # half-warp groups in one warp slow each other's steps. So a block holds
    # one lane until the lanes outnumber LANES_ALONE a SM, after which the
    # card is busy enough that packing them (MAX_BLOCK threads a block)
    # gives more lanes a second.
    gpb = 1 if n_lanes <= LANES_ALONE * n_sms else MAX_BLOCK // G
    gpb = max(1, min(gpb, fit))
    return SimPlan(G=G, rails_per_thread=1 if D + 1 <= G else 2, fault_cap=fault_cap,
                   degrade_cap=degrade_cap, group_bytes=group_bytes, groups_per_block=gpb,
                   blocks=-(-n_lanes // gpb))


def program_constants(p) -> np.ndarray:
    """The kernel's `prog` vector for a `SprayProgram` (layout in the source):
    the per-rail constants with the scratch row's fills, then the windows."""
    def ext(a, fill):
        return np.concatenate([np.asarray(a, dtype=np.float64), [fill]])

    rails = [ext(p.bw_score, 1.0), ext(p.bw_src, 1.0), ext(p.bw_dst, 1.0),
             ext(p.penalty, math.inf), ext(p.latency, 0.0), ext(p.ewma_alpha, 0.0),
             ext(p.beta0_alpha, 0.0), ext(p.beta0, 0.0), ext(p.beta1, 1.0)]
    wins = [p.fail_start, p.fail_end, p.degs_start, p.degs_end, p.degs_factor,
            p.degd_start, p.degd_end, p.degd_factor]
    return np.concatenate(rails + [np.asarray(w, dtype=np.float64).ravel() for w in wins])


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _device_guard(dev: torch.device):
    return torch.cuda.device(dev)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _n_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def plan_for(p, n_lanes: int, n_sms: int = 132) -> SimPlan:
    """`launch_plan` for the `SprayProgram` p."""
    return launch_plan(n_lanes, p.n_rails, p.rounds, p.wave, p.fail_start.shape[1],
                       p.degs_start.shape[1], p.degd_start.shape[1], n_sms)


def spray_sim(p, uf: torch.Tensor, us: torch.Tensor, ud: torch.Tensor, jm: torch.Tensor, *,
              round_robin: bool, fault_jitter: float) -> torch.Tensor:
    """Launch the sim on CUDA float64 draws stacked on a leading lane axis
    (the shapes of `make_draws`), read in that layout. Returns an
    (n_lanes, 5) float64 tensor. Raises ValueError, before anything is
    built or launched, for draws or a program the kernel does not take."""
    global launches
    dev = jm.device
    for name, t in (("uf", uf), ("us", us), ("ud", ud), ("jm", jm)):
        if not (_on_card(t) and t.dtype == torch.float64 and t.device == dev):
            raise ValueError(f"spray_sim: draws[{name!r}] must be float64 on one CUDA device, "
                             f"got {t.dtype} on {t.device}")
    D, R, W = p.n_rails, p.rounds, p.wave
    Kf, Ks, Kd = p.fail_start.shape[1], p.degs_start.shape[1], p.degd_start.shape[1]
    n = jm.shape[0]
    want = {"uf": (n, D, Kf, 2), "us": (n, D, Ks, 3), "ud": (n, D, Kd, 3), "jm": (n, R, W, 2)}
    for name, t in (("uf", uf), ("us", us), ("ud", ud), ("jm", jm)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"spray_sim: draws[{name!r}] has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"spray_sim: draws[{name!r}] must be contiguous")
    if jm.data_ptr() % 16:
        raise ValueError("spray_sim: draws['jm'] must be 16-byte aligned (cp.async)")
    plan = plan_for(p, n, _n_sms(dev))
    lib = load()
    prog = torch.from_numpy(program_constants(p)).to(dev)
    out = torch.empty((n, 5), dtype=torch.float64, device=dev)
    fj = float(fault_jitter)
    inv = math.inf if fj == 0 else 1.0 / fj
    with _device_guard(dev):
        err = lib.spray_sim_launch(
            prog.data_ptr(), uf.data_ptr(), us.data_ptr(), ud.data_ptr(), jm.data_ptr(),
            out.data_ptr(), n, D, R, W, Kf, Ks, Kd, int(round_robin), float(p.length),
            float(p.detect), float(p.gamma), inv, plan.G, plan.fault_cap, plan.degrade_cap,
            plan.groups_per_block, plan.group_bytes, _stream(dev))
    if err != 0:
        raise RuntimeError(f"spray_sim launch failed: cudaError {err}")
    launches += 1
    return out

