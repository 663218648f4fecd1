"""Model FLOPs the window's calls completed (from shapes: the reference's
`flops`) over the window's elapsed time at the card's bf16 peak, 989
TFLOP/s (the traced run's untraced window)."""
from tentbench.readers import mfu_pct as read  # noqa: F401
