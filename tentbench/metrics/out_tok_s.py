"""Output tokens of every call completed in the window over the window's
elapsed time (host clock)."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return sum(c.batch * c.n_new for c in run.calls) / run.window_s
