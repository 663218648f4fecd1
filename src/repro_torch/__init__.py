"""PyTorch/CUDA port of the TENT reproduction.

Mirrors the JAX package `repro` module for module: the host-side slice
spraying engine (`repro_torch.core`), model configs, the dense decoder
(`repro_torch.models`), the flash-attention kernel written for Hopper
(`repro_torch.kernels.flash_attention`) and prefill/decode disaggregated
serving over the engine (`repro_torch.serving`). It imports `torch` and
numpy, never `jax` or `repro`.
"""
