"""Median time to first token over every request of the window (host clock)."""
from tentbench.readers import percentile, ttft_ms


def read(run):
    return percentile(ttft_ms(run), 50)
