"""Stream milliseconds per frame of the render path's prep, from the
program's spans: triangle setup (with vertex normals and the clip
transform), binning and chunk layout (``wr::raster.setup``, ``.bin``,
``.chunks``)."""

from harness.spans import stream_ms


def read(t):
    return stream_ms(["wr::raster.setup", "wr::raster.bin", "wr::raster.chunks"],
                     t.counts.get("frames"))
