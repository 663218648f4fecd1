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
packed. The chooser runs as one warp with a candidate in each lane's
registers for up to 32 candidates, and above that as one block that keeps
the scores and charged queues in shared memory. The drain stages the live
batch in shared memory, links each slot's completions into a list there,
and walks each slot's list on its own thread, so it costs its deepest
slot's chain. `StagedDrain` is the drain bound once to a pinned staging
buffer: the library function, the stream and the buffer's mapped device
pointer resolved and the buffer checked when it is made, so a call is one
ctypes call that launches in place on that buffer and waits.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.tent_on_complete_many_launch.restype = ctypes.c_int
        lib.tent_on_complete_many_staged.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.tent_on_complete_many_staged.restype = ctypes.c_int
        lib.tent_mapped_pointer.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.tent_mapped_pointer.restype = ctypes.c_int
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


def _on_device(index: int, call):
    """`call()` with card `index` current, entering it only when it is not."""
    if torch.cuda.current_device() == index:
        return call()
    with torch.cuda.device(index):
        return call()


def _drain_sizes(ps: int, pm: int, m: int) -> None:
    if not (ps >= 1 and 0 <= m <= pm):
        raise ValueError(f"the drain takes ps >= 1 and 0 <= m <= pm, got {ps}, {pm}, {m}")


def complete_many(state: torch.Tensor, batch: torch.Tensor, ps: int, pm: int,
                  m: Optional[int] = None) -> None:
    """Launch the drain of the first `m` (default all `pm`) completions:
    `state` holds 8 * ps doubles (its first five vectors are updated in
    place), `batch` 4 * pm."""
    global drain_launches
    m = pm if m is None else m
    _drain_sizes(ps, pm, m)
    _check(state, 8 * ps, "the drain's state")
    _check(batch, 4 * pm, "the drain's batch")
    if batch.device != state.device:
        raise ValueError("the drain's buffers must be on one device")
    err = _on_device(state.device.index, lambda: load().tent_on_complete_many_launch(
        state.data_ptr(), ps, batch.data_ptr(), pm, m, _stream(state)))
    if err != 0:
        raise RuntimeError(f"tent_on_complete_many launch failed: cudaError {err}")
    drain_launches += 1


class StagedDrain:
    """The drain bound to one pinned host buffer `host` of 8 * ps + 4 * pm
    doubles (the state, then the batch, as `complete_many` takes them) on
    card `device`. Made once per staging buffer: it checks the buffer,
    resolves the library function, takes the buffer's mapped device pointer
    and fixes the stream that is current on the card then; every call
    launches on, and waits for, that stream, whatever stream is current
    when it is made. A call drains the first m entries in place in `host`
    and returns when the kernel has ended."""

    def __init__(self, host: torch.Tensor, device):
        if not (host.device.type == "cpu" and host.is_pinned() and host.dtype == torch.float64
                and host.dim() == 1 and host.is_contiguous()):
            raise ValueError("a staged drain needs a pinned contiguous float64 host vector, got "
                             f"{host.dtype} {tuple(host.shape)} pinned={host.is_pinned()}")
        device = torch.device(device)
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        self.host, self.size = host, host.numel()
        lib = load()
        self._fn = lib.tent_on_complete_many_staged
        ptr = ctypes.c_void_p()
        err = _on_device(self.index, lambda: lib.tent_mapped_pointer(host.data_ptr(),
                                                                      ctypes.byref(ptr)))
        if err != 0 or not ptr.value:
            raise RuntimeError(f"the staging buffer has no mapped device pointer: cudaError {err}")
        self._dev = ptr.value
        self._stream = torch.cuda.current_stream(self.index).cuda_stream

    def __call__(self, ps: int, pm: int, m: int) -> None:
        global drain_launches
        _drain_sizes(ps, pm, m)
        if 8 * ps + 4 * pm > self.size:
            raise ValueError(f"the staging buffer holds {self.size} doubles, the drain needs "
                             f"{8 * ps + 4 * pm}")
        err = _on_device(self.index, lambda: self._fn(self._dev, ps, pm, m, self._stream))
        if err != 0:
            raise RuntimeError(f"tent_on_complete_many staged drain failed: cudaError {err}")
        drain_launches += 1
