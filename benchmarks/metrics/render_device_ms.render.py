"""Device milliseconds of all CUDA kernels per frame in the traced window
of a render cell."""


def read(t):
    frames = t.counts.get("frames")
    if not frames or not t.kernels():
        return None
    return 1e3 * t.kernel_seconds() / frames
