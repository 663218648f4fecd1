"""Flash attention on Hopper: the ctypes binding of csrc/flash_attention.cu.

Replaces `repro/kernels/flash_attention/kernel.py::flash_attention_bhsd`
(the Pallas TPU kernel; body `_flash_kernel`). Causal GQA attention with an
fp32 online softmax, an optional sliding window, keys past the ragged tail
of S masked, and rows with no live key stored as zeros.

Bound on an H100 SXM (published peaks, 700 W): the causal half of the
score matrix needs 4 * D flops per live (query, key) pair, B * H * D *
2 * S * (S + 1) flops in all; the bytes are q, k, v and o read or written
once, at 3.35 TB/s. The larger time is the bound. At the serving shape
(B=4, S=1024, H=14, K=2, D=64) the call needs 7.5 GFLOP against 34 MB in
f32 (17 MB in bf16): operations bound it in both types.

- bfloat16: 989 TF/s on the tensor cores, about 8 us. The design puts both
  products on them with `wgmma` (S = Q K^T from shared memory, O += P V with
  P from registers), keeps the online softmax on the accumulator fragments
  in registers, and overlaps the `cp.async` copy of the next K/V tile with
  the products of this one (a 3-stage ring). Two warpgroups of 64 q rows
  share each K/V tile, which halves the tile traffic per row.
- float32 (TF32 off): 67 TF/s on the CUDA cores, about 0.11 ms. The old
  design's scalar shared loads (17 per 16 FMAs) set its pace; register
  micro-tiles of 4 rows x 4 keys read as float4 make it two vector loads
  per 16 FMAs, and K/V tiles are double-buffered with `cp.async`.

Both skip the kv tiles the causal mask and the window rule out, so they do
only the causal half's flops (plus the diagonal tiles' masked half), and
take the heaviest q tiles first.

The kernels are built for head dims 64 and 128. Any other D up to 128 (the
reference's limit) is zero-padded up to the next of the two, which leaves
Q K^T exact; the softmax scale stays the true D's, and the padded output
columns are dropped.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..build import load_library
from .ref import flash_attention_ref

#: Entry point -> its plain version; a (twin, reason) pair waives the match
#: of parameter names (tentlint's twin-drift rule reads this).
__torch_twins__ = {"flash_attention": (
    flash_attention_ref,
    "block_q/block_k are taken for the reference's signature; the kernel's tiles are fixed")}

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
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """Raise on what the kernel does not take; return q's, k's and v's data
    pointers and (batch, seq, head) strides, each read once."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash attention kernel: q, k, v must be on one CUDA device")
    dt = q.dtype
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape:
        raise ValueError(f"expected q (B,S,H,D) and k, v (B,S,K,D); got "
                         f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    B, S, H, D = qs
    if ks[0] != B or ks[1] != S or ks[3] != D:
        raise ValueError(f"k/v {tuple(ks)} do not match q {tuple(qs)}")
    if H % ks[2]:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {ks[2]}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"the kernel's head_dim is one of {_HEAD_DIMS}, got {D}")
    vec = 16 // q.element_size()  # the kernel copies rows in 16-byte pieces
    ptrs, strides = [], []
    for t in (q, k, v):
        ptr, (sb, ss, sh, sd) = t.data_ptr(), t.stride()
        if sd != 1:
            raise ValueError("the head_dim axis of q, k, v must be contiguous")
        if ptr % 16 or sb % vec or ss % vec or sh % vec:
            raise ValueError("every row of q, k, v must start 16-byte aligned")
        ptrs.append(ptr)
        strides += (sb, ss, sh)
    return ptrs, strides


def padded_head_dim(D: int) -> int:
    """The kernel head dim that takes D: D itself when it is 64 or 128, else
    the next of the two; D above 128 is refused, as the reference's kernel
    refuses it."""
    for width in _HEAD_DIMS:
        if 1 <= D <= width:
            return width
    raise ValueError(f"head_dim {D} is not in 1..{_HEAD_DIMS[-1]}")


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q (B,S,H,D), k/v (B,S,K,D), D up
    to 128: a D other than 64 or 128 goes in zero-padded to the next of the
    two (`padded_head_dim`) with the true D's softmax scale, and comes out
    as its first D columns. Raises if the kernel cannot be built or
    launched."""
    D = q.shape[-1]
    width = padded_head_dim(D)
    if width == D:
        return _launch(q, k, v, causal=causal, window=window, scale_dim=D)
    pad = (0, width - D)
    out = _launch(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), causal=causal, window=window,
                  scale_dim=D)
    return out[..., :D].contiguous()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int,
            scale_dim: int) -> torch.Tensor:
    """One launch on q, k, v whose head dim the kernel takes, with the
    softmax scale of head dim `scale_dim`."""
    global launches
    ptrs, strides = _check(q, k, v)
    B, S, H, D = q.shape
    fn = load().flash_attention_fwd
    out = torch.empty_like(q)  # a fifth of torch.empty's host time; its strides go along
    args = (*ptrs, out.data_ptr(), *strides, *out.stride()[:3],
            B, H, k.shape[2], S, D, int(window), int(bool(causal)), int(scale_dim),
            _DTYPES[q.dtype])
    index = q.device.index
    # the raw handle of the current stream (what torch.cuda.current_stream(index)
    # .cuda_stream returns, without building a Stream object each call)
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    launches += 1
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    return out
