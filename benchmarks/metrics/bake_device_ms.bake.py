"""Device milliseconds of all CUDA kernels per bake in the traced window."""


def read(t):
    bakes = t.counts.get("bakes")
    if not bakes or not t.kernels():
        return None
    return 1e3 * t.kernel_seconds() / bakes
