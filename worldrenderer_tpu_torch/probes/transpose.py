"""P2, the record-table transpose probe: its launch wrapper, its plain
PyTorch version and its entry point.

The kernel (``csrc/probe_transpose.cu``) replaces the TPU probe
``tools/probe_transpose.py:89 b_pallas``: x (V, R, N) f32 -> (V*N, R),
the coef-major to row-major turn of the flat record tables, through
shared-memory tiles. It is bound by bytes: each input read once, each
output written once, at the card's memory rate.

    python -m worldrenderer_tpu_torch.probes.transpose [--device cpu]
"""

from __future__ import annotations

import ctypes
import sys

import torch

from .._device import resolve_device
from ..ops import _build
from ..ops.tensor import route
from ..utils.debug import count
from . import cuda_ms, parse_device

# The TPU probe's shape: 6 views of the 999,699-entry record table, 24 rows.
V, N, R = 6, 999_699, 24
REPS = 8
MAX_R = 64  # rows the kernel's shared-memory tile takes


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """(V, R, N) -> (V*N, R), y[v*N + n, r] = x[v, r, n]."""
    v, r, n = x.shape
    return x.transpose(1, 2).reshape(v * n, r)


def transpose(x: torch.Tensor) -> torch.Tensor:
    """P2 on the input's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Counts its CUDA launches as
    ``launch.p2``."""
    if x.dtype != torch.float32 or x.ndim != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (V, R, N) float32 tensor")
    v, r, n = x.shape
    if not 1 <= r <= MAX_R:
        raise ValueError(f"R = {r} outside 1..{MAX_R}")

    def launch():
        y = torch.empty((v * n, r), dtype=torch.float32, device=x.device)
        if y.numel() == 0:
            return y
        _build.launch("probe_transpose", "transpose_launch",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                      + [ctypes.c_longlong], x.device,
                      x.data_ptr(), y.data_ptr(), v, r, n)
        count("launch.p2")
        return y

    return route("P2 transpose", x.device, lambda: transpose_plain(x), launch)


def checksum(y: torch.Tensor) -> float:
    """The TPU probe's checksum: both ends and a stride of the output."""
    return float(y[::797].sum() + y[-3:].sum() + y[123, 7])


def main(argv=None) -> int:
    """The TPU probe's case: each variant's checksum, then three rounds of
    ms per transpose and GB/s (bytes read + written)."""
    dev = resolve_device(parse_device(argv, __doc__.splitlines()[0]))
    g = torch.Generator(device=dev).manual_seed(0)
    x3 = torch.randn((V, R, N), generator=g, device=dev)
    variants = {"kernel": transpose, "transpose": transpose_plain}
    ref = None
    for name, fn in variants.items():
        v = checksum(fn(x3))
        ref = v if ref is None else ref
        print(f"{name:9s} checksum {v:.6f} (ref delta {v - ref:.3e})", flush=True)
    if dev.type != "cuda":
        return 0
    gb = V * N * R * 4 * 2 / 1e9
    for rnd in range(3):
        for name, fn in variants.items():
            ms = cuda_ms(lambda fn=fn: fn(x3), REPS)
            print(f"round {rnd} {name:9s} {ms:8.4f} ms/transpose "
                  f"({gb / (ms / 1e3):7.1f} GB/s rw)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
