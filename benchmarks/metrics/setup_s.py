"""Seconds from the process's start to the window's: imports, the card,
the kernels' build or load, the inputs from the seed, the program's
configuration and the warm request."""


def read(w):
    return w.setup_s
