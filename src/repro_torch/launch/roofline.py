"""Roofline terms of a dry-run case on an NVIDIA H100.

Counterpart of `repro.launch.roofline`'s arithmetic. Three terms per
(arch x shape x mesh), in seconds (per step, per rank):

    compute    = FLOPs_per_rank / peak_FLOP/s
    memory     = bytes_per_rank / HBM_bw
    collective = collective_bytes_per_rank / link_bw

The counts come from `op_analysis.analyze_ops`. The constants are the
published rates of an NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, taken
from data sheets, not measured:

  * PEAK_FLOPS 989e12: dense bf16 on the tensor cores (NVIDIA H100 data
    sheet);
  * HBM_BW 3.35e12 B/s and HBM_BYTES 80 GB (the same sheet);
  * LINK_BW 50e9 B/s a GPU: the production meshes' 16-rank `model` axis
    spans two 8-GPU HGX nodes, so a collective over it crosses the
    inter-node network, one 400 Gb/s NDR InfiniBand NIC a GPU (ConnectX-7,
    NVIDIA DGX H100 user guide). Every collective is charged at this rate.
    For comparison only: inside a node NVLink 4 gives 450e9 B/s a direction
    a GPU (900 GB/s bidirectional, the H100 data sheet).
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # bf16 dense, FLOP/s a GPU
HBM_BW = 3.35e12  # bytes/s a GPU
LINK_BW = 50e9  # bytes/s a GPU, one 400 Gb/s NDR NIC (inter-node)
HBM_BYTES = 80e9  # the card's 80 GB of HBM3 (data sheet)


@dataclasses.dataclass
class Roofline:
    flops: float  # per rank
    hbm_bytes: float  # per rank
    coll_bytes: float  # per rank
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float  # 6 N D (or 6 N_active D)
    useful_ratio: float  # MODEL_FLOPS / (FLOPs * ranks)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze_terms(*, flops: float, hbm: float, coll: float, chips: int,
                  model_flops: float) -> Roofline:
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    collective_s = coll / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops * chips
    return Roofline(
        flops=flops,
        hbm_bytes=hbm,
        coll_bytes=float(coll),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
    )


def analyze(stats, *, chips: int, model_flops: float) -> Roofline:
    """The terms of an `op_analysis.OpStats` (flops, bytes, collective bytes
    per rank)."""
    return analyze_terms(flops=stats.flops, hbm=stats.bytes, coll=stats.collective_bytes,
                         chips=chips, model_flops=model_flops)
