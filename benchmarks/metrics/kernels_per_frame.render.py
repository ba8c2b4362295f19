"""CUDA kernels per frame in the traced window of a render cell: the
launch count that the port's host-paced prep makes per frame."""


def read(t):
    frames = t.counts.get("frames")
    if not frames or not t.kernels():
        return None
    return len(t.kernels()) / frames
