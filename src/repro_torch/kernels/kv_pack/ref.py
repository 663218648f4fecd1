"""Plain torch versions of the KV-page gather and scatter.

Mirror `repro.kernels.kv_pack.ref`: `pool[indices]`, and
`pool[indices] = buf`, which here writes into the given pool and returns
it (the reference returns an updated copy). Only the CPU wrapper and the
checks use them.
"""
from __future__ import annotations

import torch


def kv_pack_ref(pool: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    return pool[indices.long()]


def kv_unpack_ref(pool: torch.Tensor, buf: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    pool[indices.long()] = buf
    return pool
