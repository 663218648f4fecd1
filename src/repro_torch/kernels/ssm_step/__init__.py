from .ops import mamba2_step
from .ref import decay, mamba2_step_ref, ssd_step

__all__ = ["decay", "mamba2_step", "mamba2_step_ref", "ssd_step"]
