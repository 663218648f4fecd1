"""Flash attention on Hopper: the ctypes binding of csrc/flash_attention.cu.

Replaces `repro/kernels/flash_attention/kernel.py::flash_attention_bhsd`
(the Pallas TPU kernel; body `_flash_kernel`). Causal GQA attention with an
fp32 online softmax, an optional sliding window, keys past the ragged tail
of S masked, and rows with no live key stored as zeros.

Bound on an H100 SXM (published peaks, 700 W): the causal half of the
score matrix needs 4 * D flops per live (query, key) pair, B * H * D *
2 * S * (S + 1) flops in all. On the tensor cores in bf16 that takes
flops / 989 TF/s; in f32 with TF32 off it runs on the CUDA cores at about
67 TF/s. The bytes are q, k, v and o read or written once, at 3.35 TB/s.
The larger time is the bound. At the serving shape (B=4, S=1024, H=14,
K=2, D=64) the f32 call needs 7.5 GFLOP against 34 MB: operations bound
it, at about 0.11 ms; in bf16 it is also operation-bound, at about 8 us.

What the simple design does about it: it reads each K/V tile once per
64-row q tile into shared memory and keeps the softmax state in
registers, so device-memory traffic stays near the bound's bytes, and it
skips the kv tiles the causal mask and the window rule out, so it does
only the causal half's flops. It does them on the CUDA cores from shared
memory (no wgmma, no TMA), so it cannot reach the bf16 tensor-core bound;
wgmma with TMA-fed tiles is the way there.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library
from .ref import flash_attention_ref

__torch_twins__ = {"flash_attention": flash_attention_ref}

#: Kernel launches since the count was last set to 0.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_lib = None


def load() -> ctypes.CDLL:
    """Build (on first use) and load the kernel's library."""
    global _lib
    if _lib is None:
        lib = load_library("flash_attention", ["flash_attention.cu"])
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash attention kernel: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,H,D) and k, v (B,S,K,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {k.shape[2]}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the head_dim axis of q, k, v must be contiguous")


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q (B,S,H,D), k/v (B,S,K,D). Raises
    if the kernel cannot be built or launched."""
    global launches
    _check(q, k, v)
    B, S, H, D = q.shape
    K = k.shape[2]
    fn = load().flash_attention_fwd
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 B, H, K, S, D, int(window), int(bool(causal)),
                 _DTYPES[q.dtype], stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    return out
