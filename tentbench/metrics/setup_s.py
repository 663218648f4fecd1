"""Seconds from the process's start to the first timed call: imports, the
card's context, kernel builds where none is cached, weights, the engine and
the warm-up of every shape the traffic uses."""


def read(run):
    return run.setup_s
