"""Host milliseconds per bake inside ``wr::bake``: the host's time to
issue a bake's work. Near the bake's time, the host sets the pace."""

from harness.spans import host_ms


def read(t):
    return host_ms("wr::bake", t.counts.get("bakes"))
