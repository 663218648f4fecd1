"""Mean host time of one decode step: the `greedy_decode` span over its
n_new - 1 steps (`models/model.py::decode_step`)."""


def read(run):
    steps = sum(c.n_new - 1 for c in run.calls)
    if steps <= 0:
        return None
    return sum(c.spans.get("decode", 0.0) for c in run.calls) / steps * 1e3
