"""Mean host span a call of `prefill_forward`, synchronised (the model,
`models/model.py`, with its kernels)."""
from tentbench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "prefill")
