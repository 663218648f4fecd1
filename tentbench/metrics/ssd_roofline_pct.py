"""Share of its roofline that the SSD scan reaches in prefill: the least
time of each call over the device time of the kernels launched inside the
mixer's scan call (device trace).

The least time is frozen here: each product counted once, C B^T once per
(batch, chunk) over its causal half (2N flops a pair), the intra-chunk
product over the causal half (2P a pair and head), C state^T and the state
update (2 L P N each a batch, head and chunk), for the steps the data has;
x, a, B, C (and an initial fp32 state) read once, y and the fp32 final
state written once."""
import torch

from tentbench import peaks
from tentbench.readers import roofline_pct


def ssd_bound(B, S, H, P, N, chunk, dtype, with_state=False):
    """(ms, bound by) of the SSD scan over these shapes."""
    lens = [min(chunk, S - t0) for t0 in range(0, S, chunk)]
    pairs = sum(n * (n + 1) / 2 for n in lens)
    flops = B * (2 * N * pairs + H * (2 * P * pairs + 4.0 * S * P * N))
    el = torch.finfo(dtype).bits // 8
    nbytes = el * (2 * B * S * H * P + B * S * H + 2 * B * S * N) + 4 * B * H * P * N * (
        2 if with_state else 1)
    return peaks.bound_ms(flops, nbytes, dtype)


def read(run):
    return roofline_pct(run, "ssd", lambda s: ssd_bound(*s)[0])
