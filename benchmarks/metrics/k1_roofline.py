"""K1's share of its roofline in a render cell: the least time of the
entries the benchmark counts for the traced frames
(``harness/roofline.py``) over K1's device time in the trace, by its
kernel's name. Nothing when the trace holds no K1 launch."""

from harness.roofline import k1_least_seconds

K1_KERNEL = "gbuffer_tiles_kernel"


def read(t):
    work = t.counts.get("k1")
    k1_s = t.kernel_seconds(K1_KERNEL)
    if not work or not work["entries"] or k1_s <= 0:
        return None
    least, _ = k1_least_seconds(work)
    return 100.0 * least / k1_s
