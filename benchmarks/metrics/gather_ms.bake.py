"""Stream milliseconds per bake of the texel gathers, from the program's
spans: the view maps' (``wr::bake.gather_geometry``) and the images'
(``wr::bake.gather_images``)."""

from harness.spans import stream_ms


def read(t):
    return stream_ms(["wr::bake.gather_geometry", "wr::bake.gather_images"],
                     t.counts.get("bakes"))
