from .ops import (Staging, choose_wave_padded_np, choose_wave_staged, complete_many_np,
                  complete_many_staged)
from .ref import tent_choose_wave_padded_ref, tent_on_complete_many_ref

__all__ = ["Staging", "choose_wave_padded_np", "choose_wave_staged", "complete_many_np",
           "complete_many_staged", "tent_choose_wave_padded_ref", "tent_on_complete_many_ref"]
