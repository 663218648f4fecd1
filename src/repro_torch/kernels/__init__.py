"""Hand-written Hopper kernels. Each kernel package keeps the reference's
layout: `kernel.py` (the binding and launch counter), `ops.py` (the public
wrapper) and `ref.py` (the plain torch version). Sources are in `csrc/`."""
