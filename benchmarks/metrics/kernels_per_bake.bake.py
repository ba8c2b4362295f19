"""CUDA kernels per bake in the traced window."""


def read(t):
    bakes = t.counts.get("bakes")
    if not bakes or not t.kernels():
        return None
    return len(t.kernels()) / bakes
