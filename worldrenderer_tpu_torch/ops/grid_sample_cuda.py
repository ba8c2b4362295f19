"""Kernel S1, the bake's bilinear texel sampler: its launch wrapper.

S1 (``csrc/grid_sample_bilinear.cu``) computes
``ops/grid_sample.py grid_sample_parts`` on CUDA tensors: per (view, texel)
it reads the NDC pair, reads the four bilinear taps of every part's
channels straight from the channels-last maps and writes their blend, bit
for bit the plain version's (``grid_sample_parts_plain``, which gathers
rows of a zero-padded quad table). It replaces no TPU kernel: the JAX
package's ``worldrenderer_tpu/ops/grid_sample.py:74 grid_sample_parts`` is
plain XLA. It is bound by bytes (the NDC read and the output written once;
one view's maps stay in L2), see the source's note. ``'u8'`` parts are
read as the bytes of their ``_quantize_u8`` copy, which the wrapper makes,
through the plain version's byte table. One wrapper call launches one
CUDA kernel per eight parts and never waits on the card.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..utils.debug import annotate, count
from . import _build
from .texture import _byte_values_np, _quantize_u8

# Parts one launch takes (the kernel's argument block holds their pointers).
MAX_PARTS = 8


def _check(parts: Sequence[Tuple[torch.Tensor, str]], grid: torch.Tensor):
    if not parts:
        raise ValueError("S1 needs at least one part")
    images = [im for im, _ in parts]
    if grid.dtype != torch.float32 or any(im.dtype != torch.float32
                                          for im in images):
        raise TypeError("grid and every part must be float32")
    if grid.ndim != 4 or grid.shape[-1] != 2:
        raise ValueError(f"grid must be (N, Hg, Wg, 2), got {tuple(grid.shape)}")
    n = grid.shape[0]
    for im, pm in parts:
        if pm not in ("none", "u8"):
            raise ValueError(f"unknown pack_mode {pm!r}")
        if im.ndim != 4 or im.shape[0] != n or im.shape[-1] < 1:
            raise ValueError(f"part {tuple(im.shape)} must be (N, H, W, C) "
                             f"with the grid's N = {n}")
        if tuple(im.shape[1:3]) != tuple(images[0].shape[1:3]):
            raise ValueError("all parts must share (N, H, W): "
                             f"{[tuple(i.shape) for i in images]}")
    tensors = [grid, *images]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("grid and every part must be contiguous")
    if any(t.device != grid.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if grid.device.type != "cuda":
        raise ValueError(f"S1 runs on CUDA tensors, not on {grid.device}")


def sample_bilinear(parts: Sequence[Tuple[torch.Tensor, str]],
                    grid: torch.Tensor) -> torch.Tensor:
    """S1: bilinear samples of the parts ((N, H, W, C_i) float32 maps, each
    with its pack mode, ``'none'`` or ``'u8'``) at ``grid`` (N, Hg, Wg, 2)
    NDC, all contiguous on one CUDA device. Returns (N, Hg, Wg, sum C_i)
    float32, the parts' samples in the parts' order. Counts each launch as
    ``launch.s1``."""
    _check(parts, grid)
    n, hg, wg, _ = grid.shape
    _, h, w, _ = parts[0][0].shape
    total = sum(im.shape[-1] for im, _ in parts)
    dev = grid.device
    out = torch.empty((n, hg, wg, total), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    # The maps as the kernel reads them: fp32, or the bytes of the
    # 255-quantized copy for a 'u8' part.
    maps = [(_quantize_u8(im) if pm == "u8" else im, pm == "u8")
            for im, pm in parts]
    table = _byte_values_np()
    with annotate("wr::s1"):
        offset = 0
        for at in range(0, len(maps), MAX_PARTS):
            group = maps[at:at + MAX_PARTS]
            k = len(group)
            data = (ctypes.c_void_p * k)(*(m.data_ptr() for m, _ in group))
            channels = (ctypes.c_int * k)(*(m.shape[-1] for m, _ in group))
            u8 = (ctypes.c_int * k)(*(int(b) for _, b in group))
            _build.launch(
                "grid_sample_bilinear", "grid_sample_bilinear_launch",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
                dev, grid.data_ptr(), out.data_ptr(), data, channels, u8, k, n,
                h, w, hg, wg, total, offset, table.ctypes.data)
            count("launch.s1")
            offset += sum(channels)
    return out
