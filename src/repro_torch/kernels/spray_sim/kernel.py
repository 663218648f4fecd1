"""The fused Monte Carlo spray sim on Hopper: the ctypes binding of
csrc/spray_sim.cu.

Replaces the reference's fused `lax.scan` program
(`repro/core/jit_core.py::_build_sim`, vmapped over seeds by
`spray_sweep`), one seed lane per thread, bit-exact with the numpy twin
`simulate_spray_ref`.

Bound on an H100 SXM: the draws are read once (the service-jitter
multipliers dominate: rounds x wave x 2 doubles a lane) and the fp64 work
is some tens of operations per rail per slice, far below 3.35 TB/s and
34 TFLOP/s. What sets the time is each lane's chain of rounds x wave
dependent slice steps, with the lanes spread one warp a block over the SMs.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..build import load_library
from .ref import spray_sim_ref

__torch_twins__ = {"spray_sim": spray_sim_ref}

#: Kernel launches since the count was last set to 0.
launches = 0

#: nvcc flags of this library: no multiply-add contraction, so every
#: product and sum rounds on its own as the numpy twin's do.
EXTRA_FLAGS = ("--fmad=false",)
MAX_RAILS = 62

_lib = None


def load() -> ctypes.CDLL:
    """Build (on first use) and load the kernel's library."""
    global _lib
    if _lib is None:
        lib = load_library("spray_sim", ["spray_sim.cu"], extra_flags=EXTRA_FLAGS)
        lib.spray_sim_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_double] * 4
            + [ctypes.c_void_p])
        lib.spray_sim_launch.restype = ctypes.c_int
        lib.spray_sim_scratch_per_lane.argtypes = [ctypes.c_int] * 5
        lib.spray_sim_scratch_per_lane.restype = ctypes.c_longlong
        _lib = lib
    return _lib


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


def spray_sim(p, uf: torch.Tensor, us: torch.Tensor, ud: torch.Tensor, jm: torch.Tensor, *,
              round_robin: bool, fault_jitter: float) -> torch.Tensor:
    """Launch the sim on CUDA float64 draws stacked on a leading lane axis
    (the shapes of `make_draws`). Returns an (n_lanes, 5) float64 tensor."""
    global launches
    dev = jm.device
    for name, t in (("uf", uf), ("us", us), ("ud", ud), ("jm", jm)):
        if not (t.is_cuda and t.dtype == torch.float64 and t.device == dev):
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
    if not 1 <= D <= MAX_RAILS:
        raise ValueError(f"spray_sim takes 1 to {MAX_RAILS} rails, got {D}")
    lib = load()
    prog = torch.from_numpy(program_constants(p)).to(dev)
    # lane-fastest: element i of lane l at [i * n + l]
    lanes_last = [t.reshape(n, -1).t().contiguous() for t in (uf, us, ud, jm)]
    per_lane = lib.spray_sim_scratch_per_lane(D, W, Kf, Ks, Kd)
    scratch = torch.empty(per_lane * n, dtype=torch.float64, device=dev)
    out = torch.empty((n, 5), dtype=torch.float64, device=dev)
    fj = float(fault_jitter)
    inv = math.inf if fj == 0 else 1.0 / fj
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spray_sim_launch(
            prog.data_ptr(), *(t.data_ptr() for t in lanes_last), scratch.data_ptr(),
            out.data_ptr(), n, D, R, W, Kf, Ks, Kd, int(round_robin), float(p.length),
            float(p.detect), float(p.gamma), inv, stream)
    if err != 0:
        raise RuntimeError(f"spray_sim launch failed: cudaError {err}")
    launches += 1
    return out
