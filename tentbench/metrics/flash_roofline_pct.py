"""Share of its roofline that causal attention reaches in prefill: the
least time of each call over the device time of the kernels launched
inside the model's attention call (device trace).

The least time is frozen here: 4 D flops per live (query, key) pair
against q, k, v and o moved once, at the peak of the inputs' type."""
import numpy as np
import torch

from tentbench import peaks
from tentbench.readers import roofline_pct


def flash_bound(B, S, H, K, D, dtype, window=0):
    """(ms, bound by) of causal attention over these shapes."""
    q = np.arange(S)
    live = q + 1 if window <= 0 else np.minimum(q + 1, window)
    flops = 4.0 * D * float(live.sum()) * B * H
    nbytes = (2 * B * S * H * D + 2 * B * S * K * D) * torch.finfo(dtype).bits // 8
    return peaks.bound_ms(flops, nbytes, dtype)


def read(run):
    return roofline_pct(run, "attention", lambda s: flash_bound(*s)[0])
