"""The jitted engine core on Hopper: the ctypes binding of csrc/tent_core.cu.

Replaces the reference's XLA-jitted `tent_choose_wave_padded_jnp` (one wave
of Algorithm 1) and `tent_on_complete_many_jnp` (one Eq. 1 EWMA drain),
`repro/core/scheduler.py:552` and `:489`, which `EngineJitCore` runs on the
TPU host's accelerator. Both are fp64 and bit-exact with the numpy path.

Bound on an H100 SXM: neither moves more than a few tens of kilobytes or
does more than a few hundred thousand fp64 operations (34 TFLOP/s), so the
bound by bytes or operations is well under a microsecond; what sets the time
is the chain of dependent steps (one per slice, or per completion of a
slot) and the launch. Each call is one launch on a buffer the wrapper has
packed: the chooser runs in one block that keeps the scores and charged
queues in shared memory and reduces with warp shuffles and ballots; the
drain runs one thread per slot.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library
from .ref import tent_choose_wave_padded_ref, tent_on_complete_many_ref

__torch_twins__ = {"tent_choose_wave_padded": tent_choose_wave_padded_ref,
                   "tent_on_complete_many": tent_on_complete_many_ref}

#: Kernel launches since the counts were last set to 0, one count a kernel.
choose_launches = 0
drain_launches = 0

#: nvcc flags of this library: no multiply-add contraction, so every
#: product and sum rounds on its own as the numpy path's do.
EXTRA_FLAGS = ("--fmad=false",)

_lib = None


def load() -> ctypes.CDLL:
    """Build (on first use) and load the kernels' library."""
    global _lib
    if _lib is None:
        lib = load_library("tent_core", ["tent_core.cu"], extra_flags=EXTRA_FLAGS)
        lib.tent_choose_wave_padded_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.tent_choose_wave_padded_launch.restype = ctypes.c_int
        lib.tent_on_complete_many_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.tent_on_complete_many_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def choose_in_size(pc: int, ps: int) -> int:
    return 8 * pc + 2 * ps + 2


def choose_out_size(pc: int, ps: int) -> int:
    return 2 * ps + pc + 1


def _check(t: torch.Tensor, n: int, what: str) -> None:
    if not (t.is_cuda and t.dtype == torch.float64 and t.dim() == 1 and t.is_contiguous()
            and t.numel() >= n):
        raise ValueError(f"{what} must be a contiguous float64 CUDA vector of at least {n} "
                         f"elements, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def choose_wave_padded(inp: torch.Tensor, out: torch.Tensor, pc: int, ps: int) -> None:
    """Launch the wave chooser on packed buffers (layouts in the source):
    `inp` holds `choose_in_size(pc, ps)` doubles, `out` receives
    `choose_out_size(pc, ps)`. pc is at most 2048 (its shared memory)."""
    global choose_launches
    if not (1 <= pc <= 2048 and ps >= 0):
        raise ValueError(f"the wave chooser takes 1 to 2048 candidates, got pc={pc}, ps={ps}")
    _check(inp, choose_in_size(pc, ps), "the chooser's input")
    _check(out, choose_out_size(pc, ps), "the chooser's output")
    if out.device != inp.device:
        raise ValueError("the chooser's buffers must be on one device")
    with torch.cuda.device(inp.device):
        err = load().tent_choose_wave_padded_launch(inp.data_ptr(), out.data_ptr(), pc, ps,
                                                    _stream(inp))
    if err != 0:
        raise RuntimeError(f"tent_choose_wave_padded launch failed: cudaError {err}")
    choose_launches += 1


def complete_many(state: torch.Tensor, batch: torch.Tensor, ps: int, pm: int) -> None:
    """Launch the drain: `state` holds 8 * ps doubles (its first five
    vectors are updated in place), `batch` 4 * pm."""
    global drain_launches
    if ps < 1 or pm < 0:
        raise ValueError(f"the drain takes ps >= 1 and pm >= 0, got {ps}, {pm}")
    _check(state, 8 * ps, "the drain's state")
    _check(batch, 4 * pm, "the drain's batch")
    if batch.device != state.device:
        raise ValueError("the drain's buffers must be on one device")
    with torch.cuda.device(state.device):
        err = load().tent_on_complete_many_launch(state.data_ptr(), ps, batch.data_ptr(), pm,
                                                  _stream(state))
    if err != 0:
        raise RuntimeError(f"tent_on_complete_many launch failed: cudaError {err}")
    drain_launches += 1
