"""Mamba2 decode step on Hopper: the ctypes binding of csrc/ssm_step.cu.

Replaces no TPU kernel: the JAX package's decode step
(`repro/models/ssm.py::mamba2_mixer_step`, `::ssd_step`) is plain jnp that
XLA fuses on the TPU. In eager PyTorch the same stretch, from the
in-projection's output to the gated norm's input, is about 30 kernels a
layer: the conv window's concatenation, product, bias and SiLU, the decay's
casts, softplus and exps, and five passes over the fp32 state (the decay's
multiply, the x B outer product, their sum, the C contraction, the copy
back into the cache). Here it is two kernels a layer: `conv_step` (the
conv, bias and SiLU, the window shifted in place) and `state_step` (the
decay, the state update read and written once in place, y with the D skip).

Bound on an H100 SXM (published peaks, 700 W): bytes. The state's read and
write, 2 B H P N 4 bytes: at mamba2-370m's decode shape (B=8, H=32, P=64,
N=128) 16.8 MB a layer, 5.0 us at 3.35 TB/s. The conv step moves about 13 B
(H P + 2 N) 2 bytes in bf16 (0.5 MB there), and the update does 4 FLOP per 8
bytes of state, so no tensor core helps.

What the design does about it: the state is touched once, read as float4,
four loads in flight a thread before any is used; a block holds 2,048
floats of one head's state (16 rows at N = 128), which gives 1,024 blocks
at mamba2's shape and 512 at granite's (B=1, H=128) for 132 SMs. Both
kernels launch on the current stream and allocate nothing: the wrapper
allocates the conv output and y with `torch.empty`, so a CUDA graph
captures the launch and its memory like any other op's.

`launches` counts calls of `mamba2_step` (one a Mamba2 layer of a decode
step, two kernels each).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor

from .. import refuse_autograd
from ..build import load_library
from .ref import mamba2_step_ref

#: Entry point -> its plain version (tentlint's twin-drift rule reads this).
__torch_twins__ = {"mamba2_step": mamba2_step_ref}

#: Calls that launched the kernels, since the count was last set to 0.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The conv width, and the largest head dim and state size, the kernels take
#: (the state size a power of two from 4): every configuration's.
CONV_WIDTH, MAX_HEADDIM, MAX_STATE = 4, 64, 128
_lib = None


def load() -> ctypes.CDLL:
    """Build (on first use) and load the kernels' library."""
    global _lib
    if _lib is None:
        lib = load_library("ssm_step", ["ssm_step.cu"])
        fn = lib.mamba2_step_fwd
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(xBC, dt, conv_buf, state, conv_w, conv_b, dt_bias, A_log, D) -> None:
    """Raise for operands the kernels are not built for: a DTensor, mixed or
    other dtypes, a state that is not a contiguous fp32 (b, nh, hd, N),
    widths out of the limits, shapes that disagree, tensors off the card."""
    acts = (xBC, dt, conv_buf, conv_w, conv_b, dt_bias, A_log, D)
    if any(isinstance(t, DTensor) for t in acts + (state,)):
        raise TypeError("ssm step kernels take local tensors, not DTensors")
    if xBC.dtype not in _DTYPES or any(t.dtype != xBC.dtype for t in acts):
        raise TypeError(f"ssm step kernels take float32 or bfloat16 activations, buffer and "
                        f"weights of one dtype, got {sorted({str(t.dtype) for t in acts})}")
    if state.dtype != torch.float32 or state.dim() != 4 or not state.is_contiguous():
        raise ValueError(f"the state must be a contiguous float32 (b, nh, hd, N) tensor, got "
                         f"{state.dtype} {tuple(state.shape)}")
    b, nh, hd, N = state.shape
    if not (conv_w.shape[0] == CONV_WIDTH and hd <= MAX_HEADDIM
            and 4 <= N <= MAX_STATE and N & (N - 1) == 0):
        raise ValueError(f"conv width {conv_w.shape[0]} (== {CONV_WIDTH}), head dim {hd} "
                         f"(<= {MAX_HEADDIM}) or state {N} (a power of two from 4 to "
                         f"{MAX_STATE}) out of range")
    width = nh * hd + 2 * N
    want = {"xBC": (b, width), "dt": (b, nh), "conv_buf": (b, CONV_WIDTH - 1, width),
            "conv_w": (CONV_WIDTH, width), "conv_b": (width,), "dt_bias": (nh,),
            "A_log": (nh,), "D": (nh,)}
    for name, t in zip(want, acts):
        if tuple(t.shape) != want[name] or t.stride(-1) != 1:
            raise ValueError(f"{name} must be {want[name]} with a contiguous last axis, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if not all(t.is_contiguous() for t in (conv_w, conv_b, dt_bias, A_log, D)):
        raise ValueError("conv_w, conv_b, dt_bias, A_log and D must be contiguous")
    if not (xBC.is_cuda and all(t.device == xBC.device for t in acts + (state,))):
        raise ValueError("ssm step kernels: every operand must be on one CUDA device")
    if state.data_ptr() % 16:
        raise ValueError("the state must be 16-byte aligned")


def mamba2_step(xBC: torch.Tensor, dt: torch.Tensor, conv_buf: torch.Tensor,
                state: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                dt_bias: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the two kernels on CUDA tensors: xBC (b, conv_dim) and dt (b,
    nh), rows of the in-projection's output; the layer's conv buffer (b,
    3, conv_dim) and fp32 state (b, nh, hd, N), updated in place. Returns
    (y (b, nh, hd) in xBC's dtype, conv_buf, state): the buffer and the
    state are the tensors passed in. Raises for operands the kernels are not
    built for (`_check`), and if the kernels cannot be built or launched."""
    global launches
    refuse_autograd("mamba2_step", xBC, dt, conv_buf, state, conv_w, conv_b, dt_bias, A_log, D)
    _check(xBC, dt, conv_buf, state, conv_w, conv_b, dt_bias, A_log, D)
    b, nh, hd, N = state.shape
    fn = load().mamba2_step_fwd
    conv = torch.empty(xBC.shape, dtype=xBC.dtype, device=xBC.device)
    y = torch.empty((b, nh, hd), dtype=xBC.dtype, device=xBC.device)
    args = (xBC.data_ptr(), xBC.stride(0), dt.data_ptr(), dt.stride(0),
            conv_buf.data_ptr(), conv_buf.stride(0), conv_buf.stride(1),
            conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(), A_log.data_ptr(),
            D.data_ptr(), conv.data_ptr(), state.data_ptr(), y.data_ptr(),
            b, nh, hd, N, _DTYPES[xBC.dtype])
    index = xBC.device.index
    # the raw handle of the current stream (a graph's capture stream under capture)
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    launches += 1
    if err != 0:
        raise RuntimeError(f"ssm step kernels launch failed: cudaError {err}")
    return y, conv_buf, state
