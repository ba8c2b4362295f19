"""Share of the traced window of a bake cell in which no kernel, copy or
set ran on the card."""


def read(t):
    if t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
