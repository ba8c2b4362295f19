"""Kernel K1, the fused G-buffer tile pass: its launch wrapper and its plain
PyTorch version.

K1 (``csrc/gbuffer_tiles.cu``) replaces the TPU kernel
``worldrenderer_tpu/ops/gbuffer_pallas.py:860 gbuffer_tiles_dma``. For each
(view, tile) it scans the tile's chunk run of rebased plane records and
keeps, per pixel centre, the covered entry of least z (first in list order
on ties, i.e. lowest triangle id); then it evaluates that entry's z and
value planes. It is bound by fp32 arithmetic — four plane evaluations and
six compares per (entry, pixel) pair, against 48 bytes of geometry per
entry shared by every pixel of the tile — so the kernel stages each chunk's
geometry in shared memory (cp.async, two slots), keeps per-pixel state in
registers and reads the winner's value planes only at the end. A tile of n
chunks runs as up to n blocks over slices of its pixels, so a launch lasts
as long as its total work, not its heaviest tile (see the source's note).
One wrapper call launches one CUDA kernel and never waits on the card.

Inputs (built by ``ops/gbuffer.py``):
  recs (B, 12 + 3*n_vals, L) f32 — per entry [e0|e1|e2|z|values] (a, b, g)
      planes, constants rebased to the tile origin; dead entries never cover;
  ids (B, L) i32 — triangle id per entry;
  start_chunks, n_chunks (B, sub*n_ty*n_tx) i32 — each tile's run of
      c-entry chunks, or with ``sub`` > 1 (``bin_subtile``) each band's:
      the tile's ``sub`` bands of tile_h / sub rows were binned apart, one
      (start, count) pair per band in band-row-major order; a band's
      pixels keep their tile-local ly (records rebased to the tile origin),
      so the output equals sub = 1's on the same candidates.
Outputs in image layout: z (B, ph, pw) f32 (inf on background), id
(B, ph, pw) i32 (2^30 on background), vals (B, n_vals, ph, pw) f32 (0 on
background).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .tensor import pixel_centres

BACKGROUND_ID = 2**30

# Tiles the plain version evaluates together: a (16, c, tile_h*tile_w)
# step keeps its temporaries at a few tens of MB.
_PLAIN_TILES_PER_STEP = 16

# Launches of K1 since the count was last set to 0 (the CPU path does not
# count): lets a run show that its main path went through the kernel.
launch_count = 0


def _check(recs, ids, start_chunks, n_chunks, n_vals, tile_h, n_ty, n_tx, c,
           sub):
    if recs.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError("recs must be float32 and ids int32")
    if start_chunks.dtype != torch.int32 or n_chunks.dtype != torch.int32:
        raise TypeError("start_chunks and n_chunks must be int32")
    bsz, n_rows, l_cap = recs.shape
    if n_rows != 12 + 3 * n_vals:
        raise ValueError(f"recs has {n_rows} rows, expected {12 + 3 * n_vals}")
    if tuple(ids.shape) != (bsz, l_cap) or l_cap % c:
        raise ValueError(f"ids {tuple(ids.shape)} / recs {tuple(recs.shape)} "
                         f"do not form c={c} chunks")
    if sub < 1 or tile_h % sub:
        raise ValueError(f"sub ({sub}) must be >= 1 and divide tile_h ({tile_h})")
    for t in (start_chunks, n_chunks):
        if tuple(t.shape) != (bsz, sub * n_ty * n_tx):
            raise ValueError(f"chunk runs must be ({bsz}, {sub * n_ty * n_tx})")
    tensors = (recs, ids, start_chunks, n_chunks)
    if any(t.device != recs.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def gbuffer_tiles_plain(
    recs: torch.Tensor,
    ids: torch.Tensor,
    start_chunks: torch.Tensor,
    n_chunks: torch.Tensor,
    n_vals: int,
    tile_h: int,
    tile_w: int,
    n_ty: int,
    n_tx: int,
    c: int,
    sub: int = 1,
):
    """K1's contract in plain PyTorch, on any device, with the kernel's
    arithmetic (each plane as ((a*lx) + (b*ly)) + g, separately rounded).
    With ``sub`` > 1 every band is a bin of tile_h / sub rows whose pixels
    keep their tile-local ly.

    Vectorised over (tiles, c entries, pixels): step r takes the r-th chunk
    of every tile that has one, finds each pixel's chunk-local first
    winner (least z, lowest row on ties) and merges it into the tile's
    buffer with a strict ``<`` — together the first entry in list order
    that attains the least z, as the kernel's sequential scan keeps."""
    bsz, n_rows, l_cap = recs.shape
    dev = recs.device
    band_h = tile_h // sub
    n_tiles = n_ty * sub * n_tx  # bins: the bands of every tile
    lx, ly = pixel_centres(band_h, tile_w, dev)
    p = lx.shape[0]
    lane = torch.arange(c, device=dev)
    # Band h of a tile starts h * band_h rows down: (bins, P) tile-local ly.
    band = torch.arange(n_tiles, device=dev) // n_tx % sub
    ly = (ly + (band * band_h).to(torch.float32)[:, None]).repeat(bsz, 1)

    # (B*L, 12) entry-major geometry and flat (B*L,) rows of the rest.
    geo = recs[:, :12].permute(0, 2, 1).reshape(bsz * l_cap, 12)
    start = start_chunks.reshape(-1).long()
    nch = n_chunks.reshape(-1).long()
    tile_entry0 = torch.arange(bsz * n_tiles, device=dev) // n_tiles * l_cap

    inf = float("inf")
    zbest = torch.full((bsz * n_tiles, p), inf, device=dev)
    win = torch.full((bsz * n_tiles, p), -1, dtype=torch.long, device=dev)

    def plane(co, k, ly_p):
        a, b, g = (co[..., 3 * k + i, None] for i in range(3))
        return a * lx + b * ly_p + g

    n_max = int(nch.max()) if nch.numel() else 0
    for r in range(n_max):
        active = torch.nonzero(nch > r).squeeze(1)
        for part in active.split(_PLAIN_TILES_PER_STEP):
            ent = tile_entry0[part, None] + (start[part, None] + r) * c + lane
            co = geo[ent]  # (n, c, 12)
            ly_p = ly[part, None]  # (n, 1, P)
            z = plane(co, 3, ly_p)
            cov = (
                (plane(co, 0, ly_p) >= 0) & (plane(co, 1, ly_p) >= 0)
                & (plane(co, 2, ly_p) >= 0) & (z >= -1.0) & (z <= 1.0)
            )
            zc = torch.where(cov, z, inf)
            zmin = zc.amin(dim=1)  # (n, P)
            first = torch.where(zc == zmin[:, None], lane[:, None], c).amin(dim=1)
            upd = zmin < zbest[part]
            zbest[part] = torch.where(upd, zmin, zbest[part])
            win[part] = torch.where(upd, torch.gather(ent, 1, first), win[part])

    covered = win >= 0
    w = win.clamp(min=0)
    flat = recs.reshape(bsz, n_rows, l_cap).permute(1, 0, 2).reshape(n_rows, -1)

    def winner_plane(row0):
        a, b, g = (flat[row0 + i][w] for i in range(3))
        return a * lx + b * ly + g

    z_t = torch.where(covered, winner_plane(9), inf)
    id_t = torch.where(covered, ids.reshape(-1)[w], BACKGROUND_ID).to(torch.int32)
    v_t = torch.stack(
        [torch.where(covered, winner_plane(12 + 3 * v), 0.0)
         for v in range(n_vals)],
        dim=1,
    )  # (B*n_tiles, n_vals, P)

    ph, pw = n_ty * tile_h, n_tx * tile_w
    n_by = n_ty * sub  # bin rows of band_h pixel rows

    def image(x):  # (B*n_tiles, P) -> (B, ph, pw)
        x = x.reshape(bsz, n_by, n_tx, band_h, tile_w)
        return x.permute(0, 1, 3, 2, 4).reshape(bsz, ph, pw)

    vals = v_t.reshape(bsz, n_by, n_tx, n_vals, band_h, tile_w)
    vals = vals.permute(0, 3, 1, 4, 2, 5).reshape(bsz, n_vals, ph, pw)
    return image(z_t), image(id_t), vals


def gbuffer_tiles(
    recs: torch.Tensor,
    ids: torch.Tensor,
    start_chunks: torch.Tensor,
    n_chunks: torch.Tensor,
    n_vals: int,
    tile_h: int,
    tile_w: int,
    n_ty: int,
    n_tx: int,
    c: int,
    sub: int = 1,
):
    """K1 on the inputs' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (z, id, vals) as documented above."""
    _check(recs, ids, start_chunks, n_chunks, n_vals, tile_h, n_ty, n_tx, c,
           sub)
    if recs.device.type == "cpu":
        return gbuffer_tiles_plain(
            recs, ids, start_chunks, n_chunks, n_vals, tile_h, tile_w,
            n_ty, n_tx, c, sub,
        )
    if recs.device.type != "cuda":
        raise ValueError(f"no K1 route for device {recs.device}")
    global launch_count
    bsz, n_rows, l_cap = recs.shape
    ph, pw = n_ty * tile_h, n_tx * tile_w
    dev = recs.device
    z = torch.empty((bsz, ph, pw), dtype=torch.float32, device=dev)
    idm = torch.empty((bsz, ph, pw), dtype=torch.int32, device=dev)
    vals = torch.empty((bsz, n_vals, ph, pw), dtype=torch.float32, device=dev)
    if bsz == 0:
        return z, idm, vals
    # The kernel runs the bins as tiles of tile_h / sub rows.
    _build.launch(
        "gbuffer_tiles", "gbuffer_tiles_launch",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10, dev,
        recs.data_ptr(), ids.data_ptr(), start_chunks.data_ptr(),
        n_chunks.data_ptr(), z.data_ptr(), idm.data_ptr(), vals.data_ptr(),
        bsz, n_rows, l_cap, n_ty * sub, n_tx, tile_h // sub, tile_w, n_vals,
        c, sub,
    )
    launch_count += 1
    return z, idm, vals


def occupancy(c: int, tile_w: int) -> dict:
    """K1's registers per thread, shared memory per block (bytes) and
    resident blocks per SM at chunk size ``c`` and tile width ``tile_w``,
    on the current card."""
    return _build.occupancy("gbuffer_tiles", "gbuffer_tiles_occupancy", c,
                            tile_w)
