"""Deliberate fma-hazard violations: fused-rounding ops in a bit-exact
module (this file sits under core/)."""
import torch
from torch import lerp


def ewma(mean, x, alpha):
    a = torch.addcmul(mean, x, alpha)  # VIOLATION: torch function
    b = mean.lerp(x, alpha)  # VIOLATION: Tensor method
    mean.addcdiv_(x, alpha)  # VIOLATION: in place
    c = torch.addmm(mean, x, x)  # VIOLATION: matrix form
    d = lerp(mean, x, 0.5)  # VIOLATION: imported by name
    return a, b, c, d
