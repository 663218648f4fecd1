"""Compute-time model for the serving simulator.

The fabric simulator gives *transfer* times in virtual seconds; this module
supplies the *compute* times (prefill/decode) for a model on a given chip
budget, so end-to-end serving metrics (TTFT, TPOT, throughput) can be
assembled on the same virtual clock.

Constants are calibrated two ways:
  * `from_table2()` matches the paper's 8xH800 TP8 Qwen3-235B-A22B testbed
    (baseline R1 TTFT 0.38 s @ 2048 input tokens -> ~5.4k tok/s prefill;
    TPOT < 30 ms) so the Table 2 reproduction is apples-to-apples.
  * `from_roofline()` derives rates from MODEL_FLOPS = 6 N D against a chip
    budget with an MFU assumption — used for the TPU-target what-ifs.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class PerfModel:
    prefill_tokens_per_s: float
    tpot: float  # seconds per output token

    def prefill_seconds(self, tokens: int) -> float:
        return tokens / self.prefill_tokens_per_s

    def decode_seconds(self, tokens: int) -> float:
        return tokens * self.tpot


def from_table2() -> PerfModel:
    """Paper testbed: Qwen3-235B-A22B, 8xH800, TP8 (Table 2 baseline R1)."""
    return PerfModel(prefill_tokens_per_s=2048 / 0.38, tpot=0.025)


def from_roofline(
    cfg: ModelConfig, *, chips: int, peak_flops: float = 197e12, mfu: float = 0.45
) -> PerfModel:
    n_active = cfg.param_count(active_only=True)
    flops_per_token = 2 * n_active  # forward
    rate = chips * peak_flops * mfu / flops_per_token
    # decode is memory-bound; approximate TPOT by weight-read time
    hbm = 819e9
    bytes_per_step = 2 * n_active  # bf16 weights
    tpot = bytes_per_step / (chips * hbm * 0.6)
    return PerfModel(prefill_tokens_per_s=rate, tpot=max(tpot, 1e-4))
