"""Kernels K2 and K3, the per-tile fused z + attribute pass: their launch
wrappers and their plain PyTorch versions.

K2 (``zattr_tiles``) replaces the TPU kernel
``worldrenderer_tpu/ops/gbuffer_pallas.py:290 zattr_tiles_pallas`` and K3
(``zattr_tiles_vpu``) replaces ``:209 zattr_tiles_vpu``; both live in
``csrc/zattr_tiles.cu``. They share one contract: per tile and pixel centre,
the covered entry of least z (the first chunk that reaches it, the least id
within that chunk), its id and its value planes. They differ in tie rule
and in rounding, as the TPU kernels do: K2's planes round as the
reference's fp32 plane dot; K3's TPU kernel keeps running buffers per lane
slot and reduces across slots at the end, and rounds as XLA contracts its
elementwise form. Both CUDA kernels are one sequential scan per pixel that
makes only strict improvements, with each chunk's exact z ties settled at
the chunk's end: K2's by least id within the chunk, K3's by the slot rule
with a guard (see the source's notes). Both split a tile's pixels over
blocks, so they take tiles of any size, and both are bound by fp32
arithmetic. The plain versions follow the TPU kernels' formulations.

z of a covered pixel is never -0 in K2: its TPU kernel's plane dot
accumulates from +0, so K2 and its plain version add +0 to the winner's
z. K3 keeps its TPU kernel's sign, -0 where a lane slot's least z is -0.

Inputs (built by ``ops/gbuffer.py _zattr_inputs``):
  coeffs (n_tiles, 3, R*K) f32 — coef-major blocks of K entries, R = 5 +
      n_vals blocks [e0|e1|e2|z|id|values], constants rebased to the tile
      origin; the id block is constant (a = b = 0, g = triangle id) and a
      tile's entries carry distinct ids;
  counts (n_tiles,) i32 — each list's live prefix.
Outputs, per tile: z (n_tiles, th, tw) f32 (+inf on background), id
(n_tiles, th, tw) f32 (2^30 on background), vals (n_tiles, n_vals, th, tw)
f32 (0 on background).
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
    plane_vpu,
    route,
)

BACKGROUND_ID = float(2**30)


def _check(coeffs, counts, n_vals):
    if coeffs.dtype != torch.float32 or counts.dtype != torch.int32:
        raise TypeError("coeffs must be float32 and counts int32")
    n_tiles, three, rk = coeffs.shape
    r = 5 + n_vals
    if three != 3 or n_vals < 1 or rk % r:
        raise ValueError(f"coeffs {tuple(coeffs.shape)} do not form "
                         f"(n_tiles, 3, {r}*K)")
    if tuple(counts.shape) != (n_tiles,):
        raise ValueError(f"counts must be ({n_tiles},)")
    if counts.device != coeffs.device:
        raise ValueError("all inputs must be on one device")
    if not (coeffs.is_contiguous() and counts.is_contiguous()):
        raise ValueError("all inputs must be contiguous")


def _winner_values(co, win, lx, ly, plane):
    """(n_tiles, n_vals, P) value planes of each pixel's winning entry
    ``win`` (n_tiles, P), -1 where nothing covers (0 there). Adding +0
    gives the TPU kernels' masked sum its sign of zero."""
    n_tiles, _, r, kp = co.shape
    w = win.clamp(min=0)
    vals = co[:, :, 5:].reshape(n_tiles, 3 * (r - 5), kp)
    g = torch.gather(vals, 2, w[:, None].expand(-1, vals.shape[1], -1))
    g = g.reshape(n_tiles, 3, r - 5, -1)
    v = plane(g[:, 0], g[:, 1], g[:, 2], lx, ly) + 0.0
    return torch.where(win[:, None] >= 0, v, 0.0)


def _tile_outputs(z, idv, vals, tile_h, tile_w):
    n_tiles = z.shape[0]
    return (z.reshape(n_tiles, tile_h, tile_w),
            idv.reshape(n_tiles, tile_h, tile_w),
            vals.reshape(n_tiles, -1, tile_h, tile_w))


def zattr_tiles_plain(coeffs, counts, n_vals, tile_h, tile_w, chunk):
    """K2's contract in plain PyTorch, on any device, with K2's arithmetic;
    follows ``_zattr_tile_xla`` (``ops/gbuffer.py:759``). Step r takes the
    r-th chunk of every tile that scans one: each pixel's chunk-local least
    z, the least id among its ties, merged into the tile's buffer with a
    strict ``<``. The winner's value planes are evaluated at the end, and
    z is written plus +0, so a covered z is never -0."""
    co, nch, c = pad_tile_blocks(coeffs, 5 + n_vals, counts, chunk)
    n_tiles, dev = co.shape[0], co.device
    lx, ly = pixel_centres(tile_h, tile_w, dev)
    p = lx.shape[0]
    inf = float("inf")
    zbest = torch.full((n_tiles, p), inf, device=dev)
    idbest = torch.full((n_tiles, p), BACKGROUND_ID, device=dev)
    win = torch.full((n_tiles, p), -1, dtype=torch.long, device=dev)
    lane = torch.arange(c, device=dev)
    n_max = int(nch.max()) if n_tiles else 0
    for r in range(n_max):
        active = torch.nonzero(nch > r).squeeze(1)
        for part in active.split(PLAIN_TILES_PER_STEP):
            blk = co[part, :, :, r * c:(r + 1) * c, None]  # (n, 3, R, c, 1)

            def plane(b):
                return plane_dot(blk[:, 0, b], blk[:, 1, b], blk[:, 2, b], lx, ly)

            z = plane(3)  # (n, c, P)
            cov = ((plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
                   & (z >= -1.0) & (z <= 1.0))
            idrow = blk[:, 2, 4]  # (n, c, 1): the constant id plane's value
            zc = torch.where(cov, z, inf)
            zmin = zc.amin(dim=1)  # (n, P)
            tie = zc == zmin[:, None]
            idmin = torch.where(tie, idrow, BACKGROUND_ID).amin(dim=1)
            first = torch.where(tie & (idrow == idmin[:, None]), lane[:, None],
                                c).amin(dim=1)
            upd = zmin < zbest[part]
            zbest[part] = torch.where(upd, zmin, zbest[part])
            idbest[part] = torch.where(upd, idmin, idbest[part])
            win[part] = torch.where(upd, r * c + first, win[part])
    vals = _winner_values(co, win, lx, ly, plane_dot)
    # + 0: the TPU kernel's plane dot accumulates from +0, so a covered z
    # is never -0 (a plane whose a, b and g are all -0 gives -0 here).
    return _tile_outputs(zbest + 0.0, idbest, vals, tile_h, tile_w)


def zattr_tiles_vpu_plain(coeffs, counts, n_vals, tile_h, tile_w, chunk):
    """K3's contract in plain PyTorch, on any device, with K3's arithmetic;
    follows ``_kernel_vpu`` (``ops/gbuffer_pallas.py:114``): per lane slot a
    running z, id and entry over the chunks (strict ``<``), then across the
    c slots the least z, the least id among its ties, and the winner's value
    planes."""
    co, nch, c = pad_tile_blocks(coeffs, 5 + n_vals, counts, chunk)
    n_tiles, dev = co.shape[0], co.device
    lx, ly = pixel_centres(tile_h, tile_w, dev)
    p = lx.shape[0]
    inf = float("inf")
    z_out = torch.full((n_tiles, p), inf, device=dev)
    id_out = torch.full((n_tiles, p), BACKGROUND_ID, device=dev)
    win = torch.full((n_tiles, p), -1, dtype=torch.long, device=dev)
    lane = torch.arange(c, device=dev)
    active = torch.nonzero(nch > 0).squeeze(1)
    # (split of an empty index gives one empty part: no tile scans a chunk)
    for part in active.split(PLAIN_TILES_PER_STEP) if active.numel() else ():
        n = part.shape[0]
        zrun = torch.full((n, p, c), inf, device=dev)
        idrun = torch.full((n, p, c), BACKGROUND_ID, device=dev)
        erun = torch.full((n, p, c), -1, dtype=torch.long, device=dev)
        for r in range(int(nch[part].max())):
            blk = co[part, :, :, None, r * c:(r + 1) * c]  # (n, 3, R, 1, c)

            def plane(b):
                return plane_vpu(blk[:, 0, b], blk[:, 1, b], blk[:, 2, b],
                                 lx[:, None], ly[:, None])

            z = plane(3)  # (n, P, c)
            cov = ((plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
                   & (z >= -1.0) & (z <= 1.0))
            upd = cov & (z < zrun) & (nch[part] > r)[:, None, None]
            zrun = torch.where(upd, z, zrun)
            idrun = torch.where(upd, blk[:, 2, 4], idrun)
            erun = torch.where(upd, r * c + lane, erun)
        zmin = zrun.amin(dim=2)  # (n, P)
        tie = zrun == zmin[..., None]
        idmin = torch.where(tie, idrun, BACKGROUND_ID).amin(dim=2)
        first = torch.where(tie & (idrun == idmin[..., None]), lane, c).amin(dim=2)
        covered = torch.isfinite(zmin)
        z_out[part] = zmin
        id_out[part] = torch.where(covered, idmin, BACKGROUND_ID)
        ent = torch.gather(erun, 2, first.clamp(max=c - 1)[..., None])[..., 0]
        win[part] = torch.where(covered, ent, -1)
    vals = _winner_values(co, win, lx, ly, plane_vpu)
    return _tile_outputs(z_out, id_out, vals, tile_h, tile_w)


def _launch(name, coeffs, counts, n_vals, tile_h, tile_w, chunk):
    n_tiles, _, rk = coeffs.shape
    dev = coeffs.device
    z = torch.empty((n_tiles, tile_h, tile_w), dtype=torch.float32, device=dev)
    idv = torch.empty((n_tiles, tile_h, tile_w), dtype=torch.float32, device=dev)
    vals = torch.empty((n_tiles, n_vals, tile_h, tile_w), dtype=torch.float32,
                       device=dev)
    if n_tiles == 0:
        return z, idv, vals
    _build.launch(
        "zattr_tiles", f"{name}_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6, dev,
        coeffs.data_ptr(), counts.data_ptr(), z.data_ptr(), idv.data_ptr(),
        vals.data_ptr(), n_tiles, rk // (5 + n_vals), n_vals, tile_h,
        tile_w, chunk_size(chunk),
    )
    count(f"launch.{_KERNEL[name]}")
    return z, idv, vals


# Each kernel's name in its span (wr::k2) and launch counter (launch.k2).
_KERNEL = {"zattr_tiles": "k2", "zattr_tiles_vpu": "k3"}


def _route(name, plain, coeffs, counts, n_vals, tile_h, tile_w, chunk):
    _check(coeffs, counts, n_vals)
    args = (coeffs, counts, n_vals, tile_h, tile_w, chunk)
    with annotate(f"wr::{_KERNEL[name]}"):
        return route(name, coeffs.device, lambda: plain(*args),
                     lambda: _launch(name, *args))


def zattr_tiles(coeffs, counts, n_vals, tile_h, tile_w, chunk):
    """K2 on the inputs' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (z, id, vals) as documented above.
    Counts its CUDA launches as ``launch.k2``."""
    return _route("zattr_tiles", zattr_tiles_plain, coeffs, counts, n_vals,
                  tile_h, tile_w, chunk)


def zattr_tiles_vpu(coeffs, counts, n_vals, tile_h, tile_w, chunk):
    """K3 on the inputs' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (z, id, vals) as documented above.
    Counts its CUDA launches as ``launch.k3``."""
    return _route("zattr_tiles_vpu", zattr_tiles_vpu_plain, coeffs, counts,
                  n_vals, tile_h, tile_w, chunk)


def occupancy(chunk: int, tile_w: int) -> dict:
    """K2's registers per thread, shared memory per block (bytes) and
    resident blocks per SM at this chunk and tile width, on the current
    card."""
    return _build.occupancy("zattr_tiles", "zattr_tiles_occupancy",
                            chunk_size(chunk), tile_w)


def vpu_occupancy(chunk: int, tile_w: int) -> dict:
    """K3's registers per thread, shared memory per block (bytes) and
    resident blocks per SM at this chunk and tile width, on the current
    card."""
    return _build.occupancy("zattr_tiles", "zattr_tiles_vpu_occupancy",
                            chunk_size(chunk), tile_w)
