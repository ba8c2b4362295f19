"""The yardstick of the flat-path tile kernel K1
(``worldrenderer_tpu_torch/csrc/gbuffer_tiles.cu``): the H100's peaks and
K1's per-entry work model, frozen copies of
``worldrenderer_tpu_torch/utils/roofline.py`` (``K1_OPS_PER_PAIR``,
``OPS_PER_ENTRY_ROW``, the byte count of ``k1_bound_ms``), and the
entries counted by the benchmark's own rasterizer, never by the program's
binning.

K1 is built with ``-fmad=false``: every multiply, add and compare is one
fp32 instruction and the card issues at most one per lane per cycle, half
the FMA-counted peak of 67e12/s (NVIDIA's H100 SXM data sheet, at a 700 W
power limit). An entry is a (tile, triangle) pair; each costs
``K1_OPS_PER_PAIR`` instructions per pixel of its tile and
``OPS_PER_ENTRY_ROW`` per row.

Counted entries are the least any binning must hand K1: the pairs of a
triangle and a tile in which it covers at least one pixel centre, over
the triangles K1 draws (valid, not culled, and not sent to the sort path:
with ``bin_tiny_px`` > 0, a triangle whose screen bounding box is under
``bin_tiny_px`` in both axes is the sort path's).
"""

from __future__ import annotations

from typing import Dict

import torch

from reference import raster

H100_PEAK_FP32_INSTR = 67e12 / 2
H100_HBM_BYTES_PER_S = 3.35e12
K1_OPS_PER_PAIR = 17
OPS_PER_ENTRY_ROW = 4


def k1_entries(scene: Dict, mvp: torch.Tensor, height: int, width: int,
               cfg) -> int:
    """Entries of one view (``mvp`` (4, 4)) for K1 under config ``cfg``
    (its ``tile_h``, ``tile_w``, ``bin_tiny_px``, ``backface_cull``)."""
    v_pos, tri = scene["v_pos"], scene["tri"]
    clip = raster.clip_positions(v_pos, mvp[None])[0]
    cov = raster.rasterize(clip, tri, height, width, cfg.backface_cull,
                           keep_pairs=True)
    t, pix = cov.pair_tri, cov.pair_pix
    if cfg.bin_tiny_px > 0:
        x, y, *_ = raster.screen(clip, tri, height, width)
        tiny = (((x.amax(1) - x.amin(1)) < cfg.bin_tiny_px)
                & ((y.amax(1) - y.amin(1)) < cfg.bin_tiny_px))
        keep = ~tiny[t]
        t, pix = t[keep], pix[keep]
    n_tx = -(-width // cfg.tile_w)
    tile = (pix // width) // cfg.tile_h * n_tx + (pix % width) // cfg.tile_w
    n_tiles = n_tx * -(-height // cfg.tile_h)
    return int(torch.unique(t * n_tiles + tile).numel())


def k1_least_seconds(work: Dict):
    """(seconds, "operations" or "bytes"): the least time of K1's work
    ``work`` (entries, frames, height, width, tile_h, tile_w, n_attr),
    the larger of its instructions over the instruction rate and its bytes
    (each entry's record and id read once, each output plane written once)
    over the memory rate."""
    per_entry = (work["tile_h"] * work["tile_w"] * K1_OPS_PER_PAIR
                 + work["tile_h"] * OPS_PER_ENTRY_ROW)
    ops_s = work["entries"] * per_entry / H100_PEAK_FP32_INSTR
    n_vals = work["n_attr"] + 1
    nbytes = (work["entries"] * (12 + 3 * n_vals + 1) * 4
              + work["frames"] * work["height"] * work["width"] * (2 + n_vals) * 4)
    bytes_s = nbytes / H100_HBM_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
