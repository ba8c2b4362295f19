"""Host milliseconds per frame inside ``wr::render``: the host's time to
issue a frame's work. Above ``render_device_ms.render``, the host sets the
pace."""

from harness.spans import host_ms


def read(t):
    return host_ms("wr::render", t.counts.get("frames"))
