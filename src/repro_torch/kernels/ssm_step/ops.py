"""Public Mamba2 decode-step wrapper: device dispatch.

CPU tensors go to the plain version (`ref.mamba2_step_ref`), the code the
kernels replace, op for op. Every other tensor goes to the kernels, which
check what they are given and raise for what they are not built for: a
DTensor, activations, buffer and weights of more than one dtype or of a
dtype other than float32 and bfloat16, a state that is not fp32, a conv
width other than 4, a head dim above 64, a state size that is not a power
of two up to 128 (every configuration is inside those limits). There is no
fallback.

Either way the call returns the step's conv buffer and state for the
caller to store into the cache: the plain version's are new tensors; the
kernels' are the `conv_buf` and `state` passed in, updated in place, so
storing them into the tensors they are (`copy_` onto the same memory)
moves no byte.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernel
from .ref import mamba2_step_ref


def mamba2_step(xBC: torch.Tensor, dt: torch.Tensor, conv_buf: torch.Tensor,
                state: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                dt_bias: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y (b, nh, hd) in xBC's dtype, conv_buf', state')."""
    args = (xBC, dt, conv_buf, state, conv_w, conv_b, dt_bias, A_log, D)
    if xBC.device.type == "cpu":
        return mamba2_step_ref(*args)
    return kernel.mamba2_step(*args)
