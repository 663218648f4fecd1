"""Plain torch versions of the jitted engine core's kernels.

They are the scheduler's `tent_choose_wave_padded_torch` and
`tent_on_complete_many_torch` (`repro_torch/core/scheduler.py`), the op-for-
op torch twins of the reference's `*_jnp` programs. Only the CPU wrapper
and the checks use them.
"""
from __future__ import annotations

from ...core.scheduler import (
    tent_choose_wave_padded_torch as tent_choose_wave_padded_ref,
    tent_on_complete_many_torch as tent_on_complete_many_ref,
)

__all__ = ["tent_choose_wave_padded_ref", "tent_on_complete_many_ref"]
