"""Frames completed over the whole window: all the work of the requests
that did not fail, over the time from the first issue to the last
completion."""

from harness import stats


def read(w):
    return stats.rate(sum(r.work for r in w.records if not r.failed),
                      w.t_end - w.t0)
