"""P1, the chunk-stream probe: its launch wrapper, its plain PyTorch version
and its entry point.

The kernel (``csrc/probe_chunk_stream.cu``) replaces the TPU probe
``tools/spike_dma.py:53 run``: per (view, tile) it sums the tile's run of
(8, c) f32 chunks of x (B, 8, L) (chunks ``starts[b, t]`` .. ``starts[b, t]
+ n_chunks[b, t] - 1``, loaded sixteen bytes a thread straight into
registers) and writes ``sum + iota`` over the tile's (th, tw) block of out
(B, n_tiles * th, tw). It is bound by bytes: each live chunk read once,
each output written once, at the card's memory rate. The wrapper checks
its inputs in one pass; ``ops/_build.py launch`` types the ctypes function
once and enters no device context for a tensor on the current device.

    python -m worldrenderer_tpu_torch.probes.chunk_stream [--device cpu]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..ops import _build
from . import parse_device

_THREADS = 256
_WARP = 32

# Launches of the kernel since the count was last set to 0 (the CPU path
# does not count).
launch_count = 0

def _check(x, starts, n_chunks, n_tiles, c) -> torch.device:
    """One pass over what the kernel takes; returns the inputs' device."""
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[1] != 8:
        raise ValueError("x must be (B, 8, L) float32")
    if starts.dtype != torch.int32 or n_chunks.dtype != torch.int32:
        raise TypeError("starts and n_chunks must be int32")
    runs = (x.shape[0], n_tiles)
    if starts.shape != runs or n_chunks.shape != runs:
        raise ValueError(f"chunk runs must be {runs}")
    if c not in (32, 64, 128, 256) or x.shape[2] % 4:
        raise ValueError("c must be 32, 64, 128 or 256 and L a multiple of 4")
    dev = x.device
    if starts.device != dev or n_chunks.device != dev:
        raise ValueError("all inputs must be on one device")
    if not (x.is_contiguous() and starts.is_contiguous()
            and n_chunks.is_contiguous()):
        raise ValueError("all inputs must be contiguous")
    if dev.type == "cuda":
        if x.data_ptr() % 16:
            raise ValueError("x must be 16-byte aligned for its 16-byte loads")
    elif dev.type != "cpu":
        raise ValueError(f"no P1 chunk_stream route for device {dev}")
    return dev


def chunk_stream_plain(x, starts, n_chunks, n_tiles: int, th: int, tw: int,
                       c: int = 128) -> torch.Tensor:
    """The kernel's contract and its order of adds in plain PyTorch: lane t
    of 256 sums, chunk by chunk in run order, the chunk's four-float pieces
    t, t + 256, ... (flat index row * c + col over 4 * piece ..
    4 * piece + 3), each piece's floats in order; then each warp of 32
    lanes halves its partials (s[l] + s[l + k], k = 16 .. 1) and the 8 warp
    sums halve the same way (k = 4, 2, 1)."""
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
        for lo in range(0, 8 * c, 4 * _THREADS):  # pieces t + 256 q
            piece = ch[..., lo:lo + 4 * _THREADS].unflatten(-1, (-1, 4))
            m = piece.shape[2]
            for k in range(4):
                partial[..., :m] = torch.where(
                    live, partial[..., :m] + piece[..., k], partial[..., :m])
    s = partial.unflatten(-1, (_THREADS // _WARP, _WARP))
    for k in (16, 8, 4, 2, 1):
        s = s[..., :k] + s[..., k:2 * k]
    s = s[..., 0]
    for k in (4, 2, 1):
        s = s[..., :k] + s[..., k:2 * k]
    iota = torch.arange(th * tw, dtype=torch.float32, device=x.device)
    return (s + iota).reshape(bsz, n_tiles * th, tw)


def chunk_stream(x, starts, n_chunks, n_tiles: int, th: int, tw: int,
                 c: int = 128) -> torch.Tensor:
    """P1 on the inputs' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns out (B, n_tiles * th, tw) f32."""
    global launch_count
    dev = _check(x, starts, n_chunks, n_tiles, c)
    if dev.type == "cpu":
        return chunk_stream_plain(x, starts, n_chunks, n_tiles, th, tw, c)
    out = torch.empty((x.shape[0], n_tiles * th, tw), dtype=torch.float32,
                      device=dev)
    _build.launch("probe_chunk_stream", "chunk_stream_launch",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6, dev,
                  x.data_ptr(), starts.data_ptr(), n_chunks.data_ptr(),
                  out.data_ptr(), x.shape[0], x.shape[2], n_tiles, th, tw, c)
    launch_count += 1
    return out


def empty_launch() -> None:
    """One launch of an empty kernel on the current device's stream: what a
    launch costs, the context of the probe's times (not a kernel of the
    port: no count)."""
    _build.launch("probe_chunk_stream", "empty_launch", [],
                  torch.device("cuda"))


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
