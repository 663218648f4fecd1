"""Mean host span a call of the KV handoff: from `tree_to_bytes` to
`bytes_to_tree` returned on the decode worker and its cache grown (the
serving layer, `serving/disagg.py`, with the engine inside it)."""
from tentbench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "pack", "engine", "unpack")
