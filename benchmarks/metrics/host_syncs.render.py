"""Points per frame inside ``wr::render`` at which the host waits for the
card (the program's ``host_sync.*`` counters)."""

from harness.spans import host_syncs


def read(t):
    return host_syncs("wr::render", t.counts.get("frames"))
