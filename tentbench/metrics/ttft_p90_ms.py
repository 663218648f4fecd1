"""P90 of time to first token over every request of the window (host clock),
from the request's start to its first token on the host, the KV handoff
inside it."""
from tentbench.readers import percentile, ttft_ms


def read(run):
    return percentile(ttft_ms(run), 90)
