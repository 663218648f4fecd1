"""Public wrapper of the fused spray sim: device dispatch.

The draws are numpy arrays, so the caller names the device: None means
CUDA, and raises without a card (`repro_torch.device.default_device`).
The CPU, asked for by name, runs the plain lane-batched torch sim
(`ref.py`); a CUDA device runs the `spray_sim` kernel, one lane a thread.
There is no fallback: if the kernel cannot be built or launched, this
raises.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...device import default_device
from . import kernel
from .ref import spray_sim_ref


def spray_sim(p, draws: Dict[str, np.ndarray], *, policy: str = "tent",
              fault_jitter: float = 0.0, device=None) -> torch.Tensor:
    """Run the `SprayProgram` p for every lane of `draws` (`make_draws`
    arrays stacked on a leading lane axis) on `device` (None = CUDA).
    Returns an (n_lanes, 5) float64 tensor of `(throughput, healing_s,
    bytes_ok, lost, makespan)` on that device."""
    if policy not in ("tent", "round_robin"):
        raise ValueError(f"unsupported sweep policy {policy!r}")
    dev = default_device(device)
    if dev.type == "cpu":
        return spray_sim_ref(p, draws, policy=policy, fault_jitter=fault_jitter)
    uf, us, ud, jm = (torch.as_tensor(np.asarray(draws[k], dtype=np.float64)).to(dev)
                      for k in ("uf", "us", "ud", "jm"))
    return kernel.spray_sim(p, uf, us, ud, jm, round_robin=policy == "round_robin",
                            fault_jitter=fault_jitter)
