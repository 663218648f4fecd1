"""Mesh construction on the default process group.

Counterpart of `repro.launch.mesh`. Functions, not module-level constants,
so importing this module creates no process group and touches no device:
the caller initializes the default group (a real one, or the fake backend
for a dry run) and then asks for a mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, default_device


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 ranks ("data", "model"); 2 pods = 512 ranks with a leading
    "pod" axis, over the default group, which must have exactly that many
    ranks (for a dry run: the fake backend, rank 0). The mesh is typed
    "cuda", as a deployment's is, so DTensor moves a shard from one dim to
    another with an all-to-all (a CPU-typed mesh would gather); the fake
    backend accepts it on a host without a card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != want:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"the {'x'.join(map(str, shape))} mesh needs a default process "
                           f"group of {want} ranks; it has {have}")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """(1, n) ("data", "model") over this host's cards, n =
    `torch.cuda.device_count()`, on CUDA unless the caller asks for the CPU
    (then n is the default group's size). Raises without a card when CUDA is
    asked for, and without a default group of n ranks."""
    dev = default_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else (
        dist.get_world_size() if dist.is_initialized() else 1)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"the host mesh (1, {n}) needs a default process group of {n} "
                           f"ranks; it has {have}")
    return init_device_mesh(dev.type, (1, n), mesh_dim_names=("data", "model"))
