from .convert import params_from_numpy
from .model import (
    DecoderLM,
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
    param_shapes,
    prefill,
    prefill_forward,
)

__all__ = [
    "DecoderLM", "decode_step", "encode", "forward", "init_cache", "init_params",
    "param_shapes", "params_from_numpy", "prefill", "prefill_forward",
]
