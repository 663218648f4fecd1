"""Public KV-page pack/unpack wrappers with the signatures of the
reference's `repro.kernels.kv_pack.ops`: device dispatch and the index
checks.

CPU tensors go to the plain versions (`ref.py`), as the reference's
wrappers run their kernels in interpret mode on the CPU. CUDA tensors go
to the Hopper kernels; there is no fallback: if a kernel cannot be built
or launched, this raises.

Two choices the reference leaves open, made the same way on both paths:
- an index outside [0, num_pages) raises IndexError (the Pallas kernel
  reads or writes whatever that address holds);
- a page named twice raises ValueError. On the TPU the grid runs in
  order, so the last writer would win; blocks on the card run in
  parallel and could only give that by serialising.
The indices are checked where they lie (host or card) with one read back
to the host, before anything is launched. int64 (or any integer) indices
are taken and converted to the kernels' int32.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import kv_pack_ref, kv_unpack_ref


def _page_indices(indices, num_pages: int, device: torch.device) -> torch.Tensor:
    """Check a page-index list (a tensor, numpy array or sequence of ints)
    against a pool of `num_pages` pages and return it as a contiguous int32
    tensor on `device`. Raises IndexError for an index out of range and
    ValueError for a repeated one."""
    idx = torch.as_tensor(indices)
    if idx.dim() == 1 and idx.numel() == 0:  # an empty list comes in as float32
        idx = idx.to(torch.int32)
    if idx.dim() != 1 or idx.dtype.is_floating_point or idx.dtype.is_complex \
            or idx.dtype == torch.bool:
        raise TypeError(f"page indices must be a 1-D integer array, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if idx.numel():
        srt = idx.long().sort().values
        out_of_range, repeated = torch.stack([
            (srt[0] < 0) | (srt[-1] >= num_pages),
            (srt[1:] == srt[:-1]).any()]).tolist()
        if out_of_range:
            raise IndexError(f"page index out of range for a pool of {num_pages} pages: "
                             f"min {srt[0].item()}, max {srt[-1].item()}")
        if repeated:
            raise ValueError("page indices name a page more than once")
    return idx.to(device=device, dtype=torch.int32).contiguous()


def kv_pack(pool: torch.Tensor, indices) -> torch.Tensor:
    """Gather pool[indices] into a contiguous (n, page_size, kv_dim) buffer."""
    idx = _page_indices(indices, pool.shape[0], pool.device)
    if pool.device.type == "cpu":
        return kv_pack_ref(pool, idx)
    return kernel.kv_pack(pool, idx)


def kv_unpack(pool: torch.Tensor, buf: torch.Tensor, indices) -> torch.Tensor:
    """Scatter buf rows into pool at `indices`, in place; returns `pool`
    itself (the reference donates the pool and returns its update)."""
    idx = _page_indices(indices, pool.shape[0], pool.device)
    if pool.device.type == "cpu":
        return kv_unpack_ref(pool, buf, idx)
    return kernel.kv_unpack(pool, buf, idx)
