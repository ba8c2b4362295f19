"""P3, the shared-memory gather probe: its launch wrapper, its plain
PyTorch version and its entry point.

The kernel (``csrc/probe_smem_gather.cu``) replaces the TPU probe
``tools/probe_vmem_gather.py:30 probe_pallas``: T repetitions of
``acc += take_along_axis(x, (idx0 + i) mod M, axis)`` over x, idx0
(R, 128), M = R for axis 0 and 128 for axis 1, with x staged in shared
memory. It is bound by shared-memory bandwidth: T * R * 128 four-byte
loads, which the kernel keeps in distinct banks (see its source). The probe's baseline, the texture path's quad-table row gather
(8,192 rows of a (1M, 12) table), is a PyTorch index here, not a kernel.

    python -m worldrenderer_tpu_torch.probes.smem_gather [--device cpu]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..ops import _build
from ..utils.debug import count
from . import cuda_ms, parse_device

R = 2048  # rows per gather op (window rows = gathered elements per op)
T = 400   # repetitions
LANES = 128


def smem_gather_plain(x: torch.Tensor, idx: torch.Tensor, t_reps: int,
                      axis: int) -> torch.Tensor:
    """acc = sum over i < t_reps, in i order from +0, of
    take_along_axis(x, (idx + i) mod M, axis)."""
    m = x.shape[axis]
    acc = torch.zeros_like(x)
    for i in range(t_reps):
        acc = acc + torch.gather(x, axis, torch.remainder(idx + i, m).long())
    return acc


def smem_gather(x: torch.Tensor, idx: torch.Tensor, t_reps: int,
                axis: int) -> torch.Tensor:
    """P3 on the inputs' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Counts its CUDA launches as ``launch.p3``."""
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != LANES:
        raise ValueError(f"x must be (R, {LANES}) float32")
    if idx.dtype != torch.int32 or idx.shape != x.shape:
        raise ValueError("idx must be int32 of x's shape")
    if axis not in (0, 1) or t_reps < 0:
        raise ValueError("axis must be 0 or 1 and t_reps >= 0")
    if idx.device != x.device or not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous, on one device")
    if x.device.type == "cpu":
        return smem_gather_plain(x, idx, t_reps, axis)
    if x.device.type != "cuda":
        raise ValueError(f"no P3 smem_gather route for device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for its 16-byte loads")
    out = torch.empty_like(x)
    _build.launch("probe_smem_gather", "smem_gather_launch",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3, x.device,
                  x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0],
                  t_reps, axis)
    count("launch.p3")
    return out


def occupancy(axis: int, rows: int = R) -> dict:
    """Axis ``axis``'s kernel at ``rows`` rows on the current card:
    registers per thread, shared memory per block (bytes), resident blocks
    per SM."""
    return _build.occupancy("probe_smem_gather", "smem_gather_occupancy",
                            axis, rows)


def probe_inputs(axis: int, device, rows: int = R):
    """The TPU probe's inputs, made from seed 0: x uniform in [0, 1), idx
    uniform over the gathered axis."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((rows, LANES)).astype(np.float32))
    idx = torch.from_numpy(
        rng.integers(0, rows if axis == 0 else LANES, (rows, LANES)).astype(np.int32))
    return x.to(device), idx.to(device)


def row_gather(table: torch.Tensor, idx0: torch.Tensor, reps: int) -> torch.Tensor:
    """The probe's baseline: ``reps`` gathers of rows (idx0 + i) mod n of the
    (n, 12) quad table, each summed into one total."""
    n = table.shape[0]
    acc = table.new_zeros(())
    for i in range(reps):
        acc = acc + table[torch.remainder(idx0 + i, n)].sum()
    return acc


def main(argv=None) -> int:
    """Per axis: microseconds per gather op over (R, 128), ns per element
    and per gathered row of 128; then the row-gather baseline's time for
    8,192 rows of 12 and its ns per row."""
    dev = resolve_device(parse_device(argv, __doc__.splitlines()[0]))
    for axis in (1, 0):
        x, idx = probe_inputs(axis, dev)
        if dev.type != "cuda":
            smem_gather(x, idx, 2, axis)
            print(f"axis={axis}: plain version ran on {dev.type} (T = 2)")
            continue
        ms = cuda_ms(lambda: smem_gather(x, idx, T, axis), 5)
        per_op = ms * 1e-3 / T
        print(f"axis={axis}: {per_op * 1e6:8.3f} us/op ({R}x{LANES}), "
              f"{per_op / (R * LANES) * 1e9:6.4f} ns/elem, "
              f"{per_op / R * 1e9:7.3f} ns/gathered-row-of-{LANES}", flush=True)
    if dev.type != "cuda":
        return 0
    n_rows, width, p, reps = 1024 * 1024, 12, 8192, 50
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.random((n_rows, width)).astype(np.float32)).to(dev)
    idx0 = torch.from_numpy(rng.integers(0, n_rows, (p,))).to(dev)
    per_op = cuda_ms(lambda: row_gather(table, idx0, reps), 5) * 1e-3 / reps
    print(f"rowgather: {per_op * 1e6:8.3f} us for {p} rows of {width} "
          f"-> {per_op / p * 1e9:6.3f} ns/row", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
