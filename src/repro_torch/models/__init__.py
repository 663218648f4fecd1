from .convert import params_from_numpy
from .model import (
    DecoderLM,
    abstract_params,
    cache_shapes,
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_shapes,
    prefill,
    prefill_forward,
)

__all__ = [
    "DecoderLM", "abstract_params", "cache_shapes", "decode_step", "encode", "forward",
    "init_cache", "init_params", "loss_fn", "param_shapes", "params_from_numpy", "prefill",
    "prefill_forward",
]
