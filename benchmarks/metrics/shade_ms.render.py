"""Stream milliseconds per frame of the render path after the tile kernel,
from the program's spans: the resolve, interpolation, texture sampling and
the frame's finish (``wr::raster.resolve``, ``wr::interpolate``,
``wr::texture``, ``wr::render.finish``)."""

from harness.spans import stream_ms


def read(t):
    return stream_ms(["wr::raster.resolve", "wr::interpolate", "wr::texture",
                      "wr::render.finish"], t.counts.get("frames"))
