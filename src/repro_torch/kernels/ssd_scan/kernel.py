"""SSD scan on Hopper: the ctypes binding of csrc/ssd_scan.cu.

Replaces `repro/kernels/ssd_scan/kernel.py::ssd_scan_bhsp` (the Pallas TPU
kernel; body `_ssd_kernel`). The Mamba2 SSD chunked scan: per chunk, the
intra-chunk product ((C B^T) o exp(segsum a)) x, the inter-chunk term
exp(cumsum a) . (C state^T), and the fp32 state update
state' = exp(sum a) state + x^T (B . exp(sum a - cumsum a)).

Bound on an H100 SXM (published peaks, 700 W), counting each product once:
C B^T once per (batch, chunk), since it does not depend on the head, over
the causal half (2 N flops per pair i >= j); the intra-chunk product over
the causal half (2 P flops per pair and head); C state^T and the state
update at 2 L P N flops each per (batch, head, chunk). The bytes are x, a,
B, C (and an initial state) read once, y and the final state written once,
at 3.35 TB/s. At mamba2-370m's serving shape (B=4, S=1024, H=32, P=64,
N=128, chunk 128) that is 5.4 GFLOP against 76 MB (40 MB in bf16). In
float32, with TF32 off, the work runs on the CUDA cores at about 67 TF/s
and operations bound it (about 0.08 ms). In bfloat16 the tensor cores
take the work at 989 TF/s and bytes bound it (about 0.012 ms).

What the design does about it: the TPU kernel walks the chunks of one
(batch, head) in order with the state in VMEM; on Hopper that gives B*H
blocks (128 at mamba2's shape, 100 at hymba-1.5b's) for 132 SMs, each
with its chunks in series. Here one call launches the SSD paper's
chunk-parallel phases on the current stream: `ssd_chunk_state` (each
chunk's own end state and decay, one block per (chunk, head, batch): 1024
blocks at mamba2's shape, 2400 at hymba's), `ssd_state_pass` (the only
sequential part: an elementwise walk over the chunks that turns the own
states into the states entering each chunk and the final state) and
`ssd_chunk_scan` (y from C, B, x and the entering state). The chunk
states go through fp32 scratch that this wrapper allocates, (B, H, nc, P,
N): 33.5 MB at mamba2's shape, about as many bytes as the inputs and
outputs, so bf16 trades part of its byte bound for parallelism.

bf16 runs all four products on the tensor cores with `wgmma` (fp32
accumulators), the operands in 128-byte-swizzled shared memory. x .
decay, the entering state and the decayed scores are fp32 values fed as
bf16 pairs (hi + lo, two products each): with one bf16 rounding of the
scores the result lay past the 2e-2 bar at N = 128. At N = 128 a scan
block takes four heads of one (chunk, batch): C and B are staged and
C B^T formed once, and the next head's x and state are copied while this
one computes. f32 runs on the CUDA cores (register micro-tiles read as
float4) and adds a fourth kernel, `ssd_chunk_cb`, that forms C B^T once
per (batch, chunk) for every head into (B, nc, L, L) scratch (2 MB at
mamba2's shape), which the bound counts once too. Inputs arrive by
16-byte `cp.async` where pointers and strides allow it, else by narrower
loads in the kernels.

`launches` counts calls of the public wrapper (`ops.ssd_chunked`) that
launched the kernels, one per Mamba2 layer of a prefill, though each call
launches three kernels (four in f32). A head dim P > 64 runs one
`ssd_scan` per block of 64 columns, and only the first block counts
(`count=False` for the others).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..build import load_library
from .ref import ssd_scan_ref

__torch_twins__ = {"ssd_scan": ssd_scan_ref}

#: Calls that launched the kernels, since the count was last set to 0.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_HEADDIM, MAX_STATE = 128, 64, 128
_lib = None


def load() -> ctypes.CDLL:
    """Build (on first use) and load the kernel's library."""
    global _lib
    if _lib is None:
        lib = load_library("ssd_scan", ["ssd_scan.cu"])
        fn = lib.ssd_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 13
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, a, B_in, C_in, initial_state, chunk) -> None:
    tensors = (x, a, B_in, C_in) + (() if initial_state is None else (initial_state,))
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("ssd scan kernel: x, a, B, C (and the initial state) must be on "
                         "one CUDA device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (a, B_in, C_in)):
        raise TypeError(f"ssd scan kernel takes float32 or bfloat16 x, a, B, C of one dtype, "
                        f"got {x.dtype}/{a.dtype}/{B_in.dtype}/{C_in.dtype}")
    if x.dim() != 4 or a.dim() != 3 or B_in.dim() != 3 or B_in.shape != C_in.shape:
        raise ValueError(f"expected x (B,S,H,P), a (B,S,H), B and C (B,S,N); got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, {tuple(B_in.shape)}, "
                         f"{tuple(C_in.shape)}")
    b, s, h, p = x.shape
    n = B_in.shape[-1]
    if tuple(a.shape) != (b, s, h) or tuple(B_in.shape[:2]) != (b, s):
        raise ValueError(f"a {tuple(a.shape)} or B/C {tuple(B_in.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if not (0 < p <= MAX_HEADDIM and 0 < n <= MAX_STATE and 0 < chunk <= MAX_CHUNK):
        raise ValueError(f"head dim {p} (<= {MAX_HEADDIM}), state {n} (<= {MAX_STATE}) "
                         f"or chunk {chunk} (<= {MAX_CHUNK}) out of range")
    if s == 0:
        raise ValueError("ssd scan kernel: empty sequence")
    if any(t.stride(-1) != 1 for t in (x, B_in, C_in)):
        raise ValueError("the last axis of x, B and C must be contiguous")
    if initial_state is not None and tuple(initial_state.shape) != (b, h, p, n):
        raise ValueError(f"initial state {tuple(initial_state.shape)}, expected {(b, h, p, n)}")


def ssd_scan(x: torch.Tensor, a: torch.Tensor, B_in: torch.Tensor, C_in: torch.Tensor, *,
             chunk: int, initial_state: Optional[torch.Tensor] = None,
             count: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels on CUDA tensors x (B,S,H,P), a (B,S,H), B and C
    (B,S,N), an optional fp32 initial state (B,H,P,N). Returns y (B,S,H,P)
    in x's dtype and the final state (B,H,P,N) in fp32. Raises if the
    kernels cannot be built or launched."""
    global launches
    chunk = int(chunk)
    _check(x, a, B_in, C_in, initial_state, chunk)
    b, s, h, p = x.shape
    n = B_in.shape[-1]
    s0 = None if initial_state is None else initial_state.float().contiguous()
    fn = load().ssd_scan_fwd
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    nc = -(-s // chunk)
    states = torch.empty((b, h, nc, p, n), dtype=torch.float32, device=x.device)
    decays = torch.empty((b, h, nc), dtype=torch.float32, device=x.device)
    # float32 forms C B^T once per (batch, chunk) for all heads
    cb = (torch.empty((b, nc, chunk, chunk), dtype=torch.float32, device=x.device)
          if x.dtype == torch.float32 else None)
    args = (x.data_ptr(), a.data_ptr(), B_in.data_ptr(), C_in.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), fin.data_ptr(),
            states.data_ptr(), decays.data_ptr(), None if cb is None else cb.data_ptr(),
            *x.stride()[:3], *a.stride(), *B_in.stride()[:2], *C_in.stride()[:2],
            *y.stride()[:3], b, s, h, p, n, chunk, _DTYPES[x.dtype])
    index = x.device.index
    # the raw handle of the current stream, without building a Stream object
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    launches += count
    if err != 0:
        raise RuntimeError(f"ssd scan kernels launch failed: cudaError {err}")
    return y, fin
