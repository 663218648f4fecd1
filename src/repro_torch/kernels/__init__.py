"""Hand-written Hopper kernels. Each kernel package keeps the reference's
layout: `kernel.py` (the binding and launch counter), `ops.py` (the public
wrapper) and `ref.py` (the plain torch version). Sources are in `csrc/`."""
from __future__ import annotations

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when a call would need a gradient through a hand-written
    kernel. The kernels are bound through ctypes, so their outputs carry no
    `grad_fn` and a backward pass would silently cut the gradient there; the
    reference cannot differentiate through its Pallas kernels either.
    Training takes the plain path (`use_pallas=False`) on every device."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the hand-written kernel has no backward pass; call it under "
            "torch.no_grad() or on tensors that do not require grad, or train with "
            "use_pallas=False (the plain path)")
