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

The kernels are built for head dims 64 and 128, and for MLA's q/k head dim
192 with a v head dim of 128 (DeepSeek-V3's prefill: 2 (192 + 128) flops a
live pair and head, operations-bound in both types). Any other D up to 128
(the reference's limit), or q/k and v dims that fit a built pair, are
zero-padded up to the smallest built pair that holds them, which leaves Q
K^T exact; the softmax scale stays the true D's, and the padded output
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
# (q/k head dim, v head dim) pairs the kernels are built for, smallest first
_HEAD_DIM_PAIRS = ((64, 64), (128, 128), (192, 128))
_lib = None


def load() -> ctypes.CDLL:
    """Build (on first use) and load the kernel's library."""
    global _lib
    if _lib is None:
        lib = load_library("flash_attention", ["flash_attention.cu"])
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
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
    if len(qs) != 4 or len(ks) != 4 or ks[:3] != v.shape[:3] or v.ndim != 4:
        raise ValueError(f"expected q (B,S,H,D), k (B,S,K,D) and v (B,S,K,Dv); got "
                         f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    B, S, H, D = qs
    if ks[0] != B or ks[1] != S or ks[3] != D:
        raise ValueError(f"k/v {tuple(ks)} do not match q {tuple(qs)}")
    if H % ks[2]:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {ks[2]}")
    if (D, v.shape[3]) not in _HEAD_DIM_PAIRS:
        raise ValueError(f"the kernel's (q/k, v) head dims are one of {_HEAD_DIM_PAIRS}, "
                         f"got {(D, v.shape[3])}")
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


def padded_head_dims(D: int, Dv: int) -> tuple:
    """The smallest built (q/k, v) head-dim pair that holds (D, Dv); refused
    past the largest, as the reference's kernel refuses a head_dim above
    128 (q/k above 192 here, for MLA)."""
    for pair in _HEAD_DIM_PAIRS:
        if 1 <= D <= pair[0] and 1 <= Dv <= pair[1]:
            return pair
    raise ValueError(f"head_dim {D} with v head_dim {Dv} fits none of the kernel's "
                     f"{_HEAD_DIM_PAIRS}")


def padded_head_dim(D: int) -> int:
    """The kernel head dim that takes D when v's is D too: D itself when it
    is 64 or 128, else the next of the two; D above 128 is refused."""
    return padded_head_dims(D, D)[0]


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q (B,S,H,D), k (B,S,K,D), v
    (B,S,K,Dv): (D, Dv) a built pair, (64, 64), (128, 128) or (192, 128),
    or dims that fit one go in zero-padded to the smallest such pair
    (`padded_head_dims`) with the true D's softmax scale, and come out as
    the first Dv columns. Raises if the kernel cannot be built or
    launched."""
    D, Dv = q.shape[-1], v.shape[-1]
    width, width_v = padded_head_dims(D, Dv)
    if (width, width_v) == (D, Dv):
        return _launch(q, k, v, causal=causal, window=window, scale_dim=D)
    pad, pad_v = (0, width - D), (0, width_v - Dv)
    out = _launch(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad_v), causal=causal, window=window,
                  scale_dim=D)
    return out[..., :Dv].contiguous()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int,
            scale_dim: int) -> torch.Tensor:
    """One launch on q, k, v whose head dim the kernel takes, with the
    softmax scale of head dim `scale_dim`."""
    global launches
    ptrs, strides = _check(q, k, v)
    B, S, H, D = q.shape
    Dv = v.shape[3]
    fn = load().flash_attention_fwd
    # empty_like: a fifth of torch.empty's host time; its strides go along
    out = torch.empty_like(q) if Dv == D else q.new_empty((B, S, H, Dv))
    args = (*ptrs, out.data_ptr(), *strides, *out.stride()[:3],
            B, H, k.shape[2], S, D, Dv, int(window), int(bool(causal)), int(scale_dim),
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
