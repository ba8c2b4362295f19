"""The card's peak allocated memory over the window of a bake cell
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
at the window's start), in GiB."""


def read(t):
    peak = t.counts.get("mem_peak_bytes")
    if not peak:
        return None
    return peak / 2**30
