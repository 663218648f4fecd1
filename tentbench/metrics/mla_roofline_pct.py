"""Share of its roofline that MLA's attention core reaches in prefill: the
least time of each call over the device time of the kernels launched
inside the model's attention call (device trace).

The least time is frozen here: 2 (D_qk + D_v) flops per live (query, key)
pair and head (Q K^T over D_qk, P V over D_v), against q and k (D_qk) and v
and o (D_v) moved once for every head, at the peak of the inputs' type.
D_v is the configuration's `v_head_dim`; a cell without one reads nothing."""
import numpy as np
import torch

from tentbench import peaks
from tentbench.readers import roofline_pct


def mla_bound(B, S, H, K, D, dtype, window, Dv):
    """(ms, bound by) of causal attention with q/k head dim D and v head
    dim Dv over these shapes (K, the kv heads, equals H in MLA's expanded
    form)."""
    q = np.arange(S)
    live = q + 1 if window <= 0 else np.minimum(q + 1, window)
    flops = 2.0 * (D + Dv) * float(live.sum()) * B * H
    nbytes = B * S * H * (2 * D + 2 * Dv) * torch.finfo(dtype).bits // 8
    return peaks.bound_ms(flops, nbytes, dtype)


def read(run):
    Dv = run.cell.conf.get("v_head_dim")
    if Dv is None:
        return None
    return roofline_pct(run, "attention", lambda s: mla_bound(*s, Dv)[0])
