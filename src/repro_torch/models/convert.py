"""Convert the reference package's parameters into the port's dict.

The reference's parameters are a pytree (nested dicts) of arrays; the tests
hand them over as numpy arrays, bf16 ones by way of `ml_dtypes`. numpy has
no native bf16, so those cross as their raw 16-bit patterns.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..device import DeviceLike, default_device


def tensor_from_numpy(arr: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    arr = np.array(arr)  # a contiguous copy the tensor may own
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=default_device(device), dtype=dtype or t.dtype)


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Map a nested dict of numpy arrays onto the same nesting of tensors on
    `device`, cast to `dtype` when given (else keeping each leaf's dtype)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return tensor_from_numpy(tree, device, dtype)
