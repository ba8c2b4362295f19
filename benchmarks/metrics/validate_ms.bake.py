"""Stream milliseconds per bake of the binning-budget guard
(``wr::bake.validate_binning``)."""

from harness.spans import stream_ms


def read(t):
    return stream_ms(["wr::bake.validate_binning"], t.counts.get("bakes"))
