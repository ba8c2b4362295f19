"""P1, the chunk-stream probe: its launch wrapper, its plain PyTorch version
and its entry point.

The kernel (``csrc/probe_chunk_stream.cu``) replaces the TPU probe
``tools/spike_dma.py:53 run``: per (view, tile) it sums the tile's run of
(8, c) f32 chunks of x (B, 8, L) (chunks ``starts[b, t]`` .. ``starts[b, t]
+ n_chunks[b, t] - 1``, double-buffered into shared memory with
``cp.async``) and writes ``sum + iota`` over the tile's (th, tw) block of
out (B, n_tiles * th, tw). It is bound by bytes: each live chunk read once,
each output written once, at the card's memory rate.

    python -m worldrenderer_tpu_torch.probes.chunk_stream [--device cpu]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..ops import _build
from ..ops.tensor import route
from . import parse_device

_THREADS = 256

# Launches of the kernel since the count was last set to 0 (the CPU path
# does not count).
launch_count = 0


def _check(x, starts, n_chunks, n_tiles, c):
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[1] != 8:
        raise ValueError("x must be (B, 8, L) float32")
    if starts.dtype != torch.int32 or n_chunks.dtype != torch.int32:
        raise TypeError("starts and n_chunks must be int32")
    for t in (starts, n_chunks):
        if tuple(t.shape) != (x.shape[0], n_tiles):
            raise ValueError(f"chunk runs must be ({x.shape[0]}, {n_tiles})")
    if c <= 0 or c % 32 or x.shape[2] % 4:
        raise ValueError("c must be a positive multiple of 32 and L of 4")
    tensors = (x, starts, n_chunks)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def chunk_stream_plain(x, starts, n_chunks, n_tiles: int, th: int, tw: int,
                       c: int = 128) -> torch.Tensor:
    """The kernel's contract and its order of adds in plain PyTorch: lane t
    of 256 sums chunk elements t, t + 256, ... (flat index row * c + col)
    of every chunk of the run in order, then a tree halves the 256
    partials (s[t] + s[t + k], k = 128 .. 1)."""
    bsz, _, l = x.shape
    nch_total = l // c
    base = starts.long().clamp(0, nch_total)
    nch = torch.minimum(n_chunks.long().clamp(min=0), nch_total - base)
    chunks = x[:, :, :nch_total * c].reshape(bsz, 8, nch_total, c)
    chunks = chunks.permute(0, 2, 1, 3).reshape(bsz, nch_total, 8 * c)
    bidx = torch.arange(bsz, device=x.device)[:, None]
    partial = x.new_zeros((bsz, n_tiles, _THREADS))
    for ci in range(int(nch.max()) if nch.numel() else 0):
        live = (nch > ci)[..., None]
        ch = chunks[bidx, (base + ci).clamp(max=max(nch_total - 1, 0))]
        for k in range(0, 8 * c, _THREADS):
            partial = torch.where(live, partial + ch[..., k:k + _THREADS], partial)
    k = _THREADS // 2
    while k:
        partial = partial[..., :k] + partial[..., k:2 * k]
        k //= 2
    iota = torch.arange(th * tw, dtype=torch.float32, device=x.device)
    return (partial + iota).reshape(bsz, n_tiles * th, tw)


def chunk_stream(x, starts, n_chunks, n_tiles: int, th: int, tw: int,
                 c: int = 128) -> torch.Tensor:
    """P1 on the inputs' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns out (B, n_tiles * th, tw) f32."""
    _check(x, starts, n_chunks, n_tiles, c)

    def launch():
        global launch_count
        if x.data_ptr() % 16:
            raise ValueError("x must be 16-byte aligned for cp.async")
        out = torch.empty((x.shape[0], n_tiles * th, tw), dtype=torch.float32,
                          device=x.device)
        fn = _build.load("probe_chunk_stream").chunk_stream_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), starts.data_ptr(), n_chunks.data_ptr(),
                     out.data_ptr(), x.shape[0], x.shape[2], n_tiles, th, tw, c,
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"chunk_stream launch failed: CUDA error {err}")
        launch_count += 1
        return out

    return route("P1 chunk_stream", x.device,
                 lambda: chunk_stream_plain(x, starts, n_chunks, n_tiles, th,
                                            tw, c),
                 launch)


def main(argv=None) -> int:
    """The TPU probe's own case: 2 views of 4 tiles of 16 x 128, chunks of
    128, against a numpy loop (rtol 1e-5, the probe's tolerance)."""
    dev = resolve_device(parse_device(argv, __doc__.splitlines()[0]))
    bsz, n_tiles, c = 2, 4, 128
    th, tw = 16, 128
    l = 8 * c
    x = torch.arange(bsz * 8 * l, dtype=torch.float32).reshape(bsz, 8, l) * 1e-4
    starts = torch.tensor([[0, 2, 4, 6], [1, 3, 5, 7]], dtype=torch.int32)
    nch = torch.tensor([[2, 2, 2, 0], [1, 1, 1, 1]], dtype=torch.int32)
    out = chunk_stream(x.to(dev), starts.to(dev), nch.to(dev), n_tiles, th,
                       tw, c).cpu().numpy()
    xr = x.numpy()
    for b in range(bsz):
        for i in range(n_tiles):
            acc = np.float32(0.0)
            for ci in range(int(nch[b, i])):
                s = (int(starts[b, i]) + ci) * c
                acc += xr[b, :, s:s + c].sum(dtype=np.float32)
            ref = acc + np.arange(th * tw, dtype=np.float32).reshape(th, tw)
            np.testing.assert_allclose(out[b, i * th:(i + 1) * th], ref, rtol=1e-5)
    print(f"chunk_stream OK on {dev.type} (launches {launch_count})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
