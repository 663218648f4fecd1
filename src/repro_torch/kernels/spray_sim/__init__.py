from .ops import spray_sim
from .ref import spray_sim_ref

__all__ = ["spray_sim", "spray_sim_ref"]
