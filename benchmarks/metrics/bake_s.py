"""The window's time, from the first issue to the last completion, over
the bakes completed."""


def read(w):
    return (w.t_end - w.t0) / max(1, sum(not r.failed for r in w.records))
