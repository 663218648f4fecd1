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
update at 2 L P N flops each per (batch, head, chunk). With TF32 off the
f32 work runs on the CUDA cores at about 67 TF/s. The bytes are x, a, B, C
(and an initial state) read once, y and the final state written once, at
3.35 TB/s. At mamba2-370m's serving shape (B=4, S=1024, H=32, P=64, N=128,
chunk 128) that is 5.4 GFLOP against 76 MB: operations bound it, at about
0.08 ms; bytes alone would take about 0.023 ms.

What the simple design does about it: one block per (batch, head) walks the
chunks in order with the (P, N) state in shared memory, so the state never
goes to device memory between chunks, and every input is read once per
head (B and C are shared by the heads and come from L2 after the first).
It forms C B^T per head (H times the bound's count, a small share at
mamba2's P=64, N=128), skips the tiles above the diagonal, and does its
products on the CUDA cores from shared memory (no wgmma, no TMA). One
block per (batch, head) gives B*H blocks, 128 at the serving shape for 132
SMs; splitting the scan across blocks and wgmma are the ways to the bound.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..build import load_library
from .ref import ssd_scan_ref

__torch_twins__ = {"ssd_scan": ssd_scan_ref}

#: Kernel launches since the count was last set to 0.
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
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 13
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
             chunk: int, initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors x (B,S,H,P), a (B,S,H), B and C
    (B,S,N), an optional fp32 initial state (B,H,P,N). Returns y (B,S,H,P)
    in x's dtype and the final state (B,H,P,N) in fp32. Raises if the kernel
    cannot be built or launched."""
    global launches
    chunk = int(chunk)
    _check(x, a, B_in, C_in, initial_state, chunk)
    b, s, h, p = x.shape
    n = B_in.shape[-1]
    s0 = None if initial_state is None else initial_state.float().contiguous()
    fn = load().ssd_scan_fwd
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), a.data_ptr(), B_in.data_ptr(), C_in.data_ptr(),
                 None if s0 is None else s0.data_ptr(), y.data_ptr(), fin.data_ptr(),
                 *x.stride()[:3], *a.stride(), *B_in.stride()[:2], *C_in.stride()[:2],
                 *y.stride()[:3], b, s, h, p, n, chunk, _DTYPES[x.dtype], stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f"ssd scan kernel launch failed: cudaError {err}")
    return y, fin
