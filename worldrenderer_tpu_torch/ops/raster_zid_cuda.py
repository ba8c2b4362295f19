"""Kernel K4, the classic rasterizer's z/id tile pass: its launch wrapper and
its plain PyTorch version.

K4 (``csrc/raster_zid_tiles.cu``) replaces the TPU kernel
``worldrenderer_tpu/ops/rasterize_pallas.py:97 raster_zid_tiles_pallas``.
Per tile it scans the binned list in chunks of c entries and keeps, per
pixel centre, the covered entry of least z, the least slot on ties, and
writes that slot's ``triangle id + 1``, the map the TPU kernel's wrapper
makes from its slots (the plain version returns the slots, and
``ids_from_slots`` maps them). It is bound by fp32 arithmetic (four plane evaluations and five
compares per (entry, pixel) pair), so the kernel stages each chunk's
coefficients in shared memory once per block, splits a tile's pixels over
blocks (so it takes tiles of any size) and keeps per-pixel state in
registers (see the source's note). z of a covered pixel is never -0: the
TPU kernel's plane dot accumulates from +0, so the kernel and the plain
version add +0 to the winner's z.

Inputs (built by ``ops/rasterize.py _gather_tile_coeffs``):
  coeffs (n_tiles, 3, 4K) f32 — coef-major [e0|e1|e2|z] blocks of K,
      constants rebased to the tile origin, invalid entries never cover;
  ids (n_tiles, K) i32 — the triangle of each slot;
  counts (n_tiles,) i32 — each list's live prefix.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.debug import annotate, count
from . import _build
from .tensor import (
    PLAIN_TILES_PER_STEP,
    chunk_size,
    pad_tile_blocks,
    pixel_centres,
    plane_dot,
    route,
)

BACKGROUND_SLOT = 2**30


def _check(coeffs, ids, counts):
    if coeffs.dtype != torch.float32:
        raise TypeError("coeffs must be float32")
    if ids.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("ids and counts must be int32")
    n_tiles, three, four_k = coeffs.shape
    if three != 3 or four_k % 4 or tuple(ids.shape) != (n_tiles, four_k // 4):
        raise ValueError(f"coeffs {tuple(coeffs.shape)} and ids "
                         f"{tuple(ids.shape)} do not form (n_tiles, 3, 4K) "
                         "and (n_tiles, K)")
    if tuple(counts.shape) != (n_tiles,):
        raise ValueError(f"counts must be ({n_tiles},)")
    tensors = (coeffs, ids, counts)
    if any(t.device != coeffs.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def raster_zid_tiles_plain(
    coeffs: torch.Tensor, counts: torch.Tensor, tile_h: int, tile_w: int,
    chunk: int,
):
    """K4's contract in plain PyTorch, on any device, with the kernel's
    arithmetic; follows ``_raster_zid_tile`` (``ops/rasterize.py:1178``).
    Returns (z (n_tiles, th, tw) f32, +inf where nothing covers; slot
    (n_tiles, th, tw) i32, ``BACKGROUND_SLOT`` where nothing covers).

    K is padded to a multiple of c with never-covering slots, as the TPU
    wrapper pads. Step r takes the r-th chunk of every tile that scans one:
    each pixel's chunk-local least z and least slot among its ties, merged
    into the tile's buffer with a strict ``<``; z is written plus +0, so a
    covered z is never -0."""
    n_tiles, dev = coeffs.shape[0], coeffs.device
    co, nch, c = pad_tile_blocks(coeffs, 4, counts, chunk)
    lx, ly = pixel_centres(tile_h, tile_w, dev)
    p = lx.shape[0]
    lane = torch.arange(c, device=dev)

    inf = float("inf")
    zbest = torch.full((n_tiles, p), inf, device=dev)
    slot = torch.full((n_tiles, p), BACKGROUND_SLOT, dtype=torch.int32,
                      device=dev)
    n_max = int(nch.max()) if n_tiles else 0
    for r in range(n_max):
        active = torch.nonzero(nch > r).squeeze(1)
        for part in active.split(PLAIN_TILES_PER_STEP):
            blk = co[part, :, :, r * c:(r + 1) * c, None]  # (n, 3, 4, c, 1)

            def plane(b):
                return plane_dot(blk[:, 0, b], blk[:, 1, b], blk[:, 2, b], lx, ly)

            z = plane(3)  # (n, c, P)
            cov = ((plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
                   & (z >= -1.0) & (z <= 1.0))
            zc = torch.where(cov, z, inf)
            zmin = zc.amin(dim=1)
            first = torch.where(zc == zmin[:, None], lane[:, None], c).amin(dim=1)
            upd = zmin < zbest[part]
            zbest[part] = torch.where(upd, zmin, zbest[part])
            slot[part] = torch.where(upd, (r * c + first).to(torch.int32),
                                     slot[part])
    # + 0: the TPU kernel's plane dot accumulates from +0, so a covered z
    # is never -0 (a plane whose a, b and g are all -0 gives -0 here).
    zbest = zbest + 0.0
    return zbest.reshape(n_tiles, tile_h, tile_w), slot.reshape(n_tiles, tile_h, tile_w)


def _launch(coeffs, ids, counts, tile_h, tile_w, chunk):
    n_tiles, _, four_k = coeffs.shape
    dev = coeffs.device
    z = torch.empty((n_tiles, tile_h, tile_w), dtype=torch.float32, device=dev)
    idmap = torch.empty((n_tiles, tile_h, tile_w), dtype=torch.int32, device=dev)
    if n_tiles == 0:
        return z, idmap
    _build.launch(
        "raster_zid_tiles", "raster_zid_tiles_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5, dev,
        coeffs.data_ptr(), ids.data_ptr(), counts.data_ptr(), z.data_ptr(),
        idmap.data_ptr(), n_tiles, four_k // 4, tile_h, tile_w,
        chunk_size(chunk),
    )
    count("launch.k4")
    return z, idmap


def raster_zid_tiles(
    coeffs: torch.Tensor,
    ids: torch.Tensor,
    counts: torch.Tensor,
    tile_h: int,
    tile_w: int,
    chunk: int,
):
    """K4 on the inputs' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (z (n_tiles, th, tw) f32, +inf on
    background; idmap (n_tiles, th, tw) i32, ``triangle id + 1``, 0 on
    background). Counts its CUDA launches as ``launch.k4``."""
    _check(coeffs, ids, counts)

    def plain():
        z, slot = raster_zid_tiles_plain(coeffs, counts, tile_h, tile_w, chunk)
        return z, ids_from_slots(slot, ids)

    with annotate("wr::k4"):
        return route("raster_zid_tiles", coeffs.device, plain,
                     lambda: _launch(coeffs, ids, counts, tile_h, tile_w, chunk))


def ids_from_slots(slot: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The TPU wrapper's last step, which the CUDA kernel makes itself: slot
    (n_tiles, th, tw) of each pixel's winner -> ``triangle id + 1`` from
    ids (n_tiles, K), 0 on background."""
    covered = slot < BACKGROUND_SLOT
    safe = torch.where(covered, slot, 0).reshape(slot.shape[0], -1).long()
    gid = torch.gather(ids, 1, safe).reshape(slot.shape)
    return torch.where(covered, gid + 1, 0)


def occupancy(chunk: int, tile_w: int) -> dict:
    """K4's registers per thread, shared memory per block (bytes) and
    resident blocks per SM at this chunk and tile width, on the current
    card."""
    return _build.occupancy("raster_zid_tiles", "raster_zid_tiles_occupancy",
                            chunk_size(chunk), tile_w)
