"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. There is no
silent fallback: without a card, asking for the default device raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device(device: DeviceLike = None) -> torch.device:
    """Resolve `device`; None means CUDA, and raises when there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

