"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity), at its full power limit of 700 W."""
import torch

FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """The least time of a call, (ms, "operations" or "bytes"): the larger
    of its operations at the peak rate of its type and its bytes at the
    memory's bandwidth."""
    t_ops, t_bytes = flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
