"""KV-page gather and scatter on Hopper: the ctypes binding of csrc/kv_pack.cu.

Replaces `repro/kernels/kv_pack/kernel.py::kv_pack_pages` (gather
`pool[indices]` into a contiguous buffer) and `::kv_unpack_pages` (scatter
a buffer back into pool pages, in place through input/output aliasing),
the Pallas TPU kernels.

Bound on an H100 SXM (published peaks, 700 W): pure data movement, each
moved page read once and written once, 2 * n * page_bytes at 3.35 TB/s.
For qwen2-0.5b's per-layer K|V page (16 tokens x kv_dim 256) and n = 8192
pages that is 134,217,728 bytes in f32, about 0.080 ms.

What the simple design does about it: one block per (page slot, 16 KiB
chunk of the page) loads its page index itself (Hopper has no scalar
prefetch) and copies with 16-byte vector loads and stores, four in flight
per thread, when the pointers and the page size allow it; nothing else is
read or written, so the traffic is the bound's bytes. Both kernels take
the pool and the buffer as they are: pack allocates only its output, and
unpack writes into the pool it is given.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library
from .ref import kv_pack_ref, kv_unpack_ref

#: Entry point -> its plain version (tentlint's twin-drift rule reads this).
__torch_twins__ = {"kv_pack": kv_pack_ref, "kv_unpack": kv_unpack_ref}

#: Kernel launches since the counts were last set to 0, one count a kernel.
pack_launches = 0
unpack_launches = 0

_lib = None


def load() -> ctypes.CDLL:
    """Build (on first use) and load the kernels' library."""
    global _lib
    if _lib is None:
        lib = load_library("kv_pack", ["kv_pack.cu"])
        fn = lib.kv_pages_copy
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(pool: torch.Tensor, indices: torch.Tensor, buf=None) -> None:
    tensors = (pool, indices) + (() if buf is None else (buf,))
    if not (pool.is_cuda and all(t.device == pool.device for t in tensors)):
        raise ValueError("kv page kernels: pool, indices (and buf) must be on one CUDA device")
    if pool.dim() != 3 or not pool.is_contiguous():
        raise ValueError(f"pool must be a contiguous (num_pages, page_size, kv_dim) tensor, "
                         f"got {tuple(pool.shape)}")
    if indices.dtype != torch.int32 or indices.dim() != 1 or not indices.is_contiguous():
        raise ValueError(f"indices must be a contiguous 1-D int32 tensor, got "
                         f"{indices.dtype} {tuple(indices.shape)}")
    if buf is not None:
        want = (indices.shape[0],) + tuple(pool.shape[1:])
        if buf.dtype != pool.dtype or tuple(buf.shape) != want or not buf.is_contiguous():
            raise ValueError(f"buf must be a contiguous {pool.dtype} tensor of shape {want}, "
                             f"got {buf.dtype} {tuple(buf.shape)}")


def _copy(src: torch.Tensor, dst: torch.Tensor, indices: torch.Tensor, pool: torch.Tensor,
          scatter: bool) -> None:
    page_bytes = pool.shape[1] * pool.shape[2] * pool.element_size()
    fn = load().kv_pages_copy
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        err = fn(src.data_ptr(), dst.data_ptr(), indices.data_ptr(), indices.shape[0],
                 page_bytes, pool.shape[0], int(scatter), stream)
    if err != 0:
        raise RuntimeError(f"kv page {'scatter' if scatter else 'gather'} kernel launch "
                           f"failed: cudaError {err}")


def kv_pack(pool: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Launch the gather on CUDA tensors: pool (num_pages, page_size, kv_dim)
    and int32 indices (n,) in [0, num_pages). Returns a new (n, page_size,
    kv_dim) buffer. An index out of range yields a zero page; the public
    wrapper rejects it before launching."""
    global pack_launches
    _check(pool, indices)
    out = torch.empty((indices.shape[0],) + tuple(pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    if pool.numel() and indices.shape[0]:
        _copy(pool, out, indices, pool, scatter=False)
        pack_launches += 1
    return out


def kv_unpack(pool: torch.Tensor, buf: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Launch the scatter on CUDA tensors: writes buf[i] into pool page
    indices[i], in place, and returns `pool` itself. Distinct indices give a
    defined result; an index out of range is skipped. The public wrapper
    rejects both before launching."""
    global unpack_launches
    _check(pool, indices, buf)
    if pool.numel() and indices.shape[0]:
        _copy(buf, pool, indices, pool, scatter=True)
        unpack_launches += 1
    return pool
