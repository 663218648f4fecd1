"""Mean host span a call of `ship_kv_async` and `run_until_idle`: TENT's
engine and simulated fabric (`core/engine.py`, `core/fabric.py`)."""
from tentbench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "engine")
