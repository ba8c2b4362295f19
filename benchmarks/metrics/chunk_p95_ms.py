"""The 95th percentile, over every request of the window, of a request's
latency (issue to its outputs on the host), in milliseconds."""

from harness import stats


def read(w):
    return 1e3 * stats.percentile([r.t_done - r.t_issue for r in w.records], 95)
