"""Fused G-buffer rasterization: attributes as screen-affine planes
(PyTorch counterpart of ``worldrenderer_tpu/ops/gbuffer.py``, its flat
path).

Perspective-correct interpolation of a per-vertex attribute is a ratio of
two screen-affine planes, a(p) = [sum_i e_i(p) invw_i a_i] /
[sum_i e_i(p) invw_i]; so coverage, depth, attribute numerators and the
shared denominator are all plane evaluations. The prep here bins triangles
into tiles, lays each tile's entries out as 128-aligned chunks of rebased
plane records, and kernel K1 (``gbuffer_cuda.py``) picks every pixel's
winner and evaluates its planes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..transforms import mvp_columns
from .gbuffer_cuda import BACKGROUND_ID, gbuffer_tiles
from .rasterize import (
    DEFAULT_CONFIG,
    RasterizerConfig,
    _auto_cap,
    _bin_flat,
    _check_ported,
    _clip_corners,
    _CULL_MARGIN,
    _triangle_setup_t,
    _TriSetupT,
)

__all__ = ["rasterize_gbuffer", "GBufferOutput"]

# e0 constant of a dead record: swallows any tile-origin rebase exactly in
# f32, so the entry never covers a pixel.
_BIG_NEG = -3.0e38


class GBufferOutput(NamedTuple):
    mask: torch.Tensor  # (B, H, W) bool
    z: torch.Tensor  # (B, H, W) f32 NDC depth (0 where background)
    tri_id: torch.Tensor  # (B, H, W) i32 triangle_id + 1, 0 = background
    attr: Optional[torch.Tensor]  # (B, H, W, A) perspective-correct attrs


def _attr_planes_t(setup: _TriSetupT, a3: torch.Tensor) -> torch.Tensor:
    """Numerator planes of each attribute channel plus the shared
    denominator plane: (B, (A+1)*3, T+1) rows [val0_a, val0_b, val0_g,
    val1_a, ...], denominator last. ``a3`` (A, 3, T) per-corner values."""
    bsz = setup.valid.shape[0]
    n_attr, _, t_total = a3.shape
    inv_w = setup.inv_w[:, :, :-1]  # (B, 3, T)
    ep = setup.planes12[:, :9, :-1].reshape(bsz, 3, 3, t_total)  # (edge, coef)
    s = a3[None] * inv_w[:, None]  # (B, A, 3, T)
    num = (
        s[:, :, 0, None] * ep[:, None, 0]
        + s[:, :, 1, None] * ep[:, None, 1]
        + s[:, :, 2, None] * ep[:, None, 2]
    )  # (B, A, 3coef, T)
    den = (
        inv_w[:, 0, None] * ep[:, 0]
        + inv_w[:, 1, None] * ep[:, 1]
        + inv_w[:, 2, None] * ep[:, 2]
    )  # (B, 3coef, T)
    rows = torch.cat([num.reshape(bsz, n_attr * 3, t_total), den], dim=1)
    return torch.cat([rows, rows.new_zeros(bsz, rows.shape[1], 1)], dim=2)


def _flat_chunks(
    setup: _TriSetupT,
    attr_rows: torch.Tensor,
    flat,
    k_cap: int,
    c: int,
    l_cap: int,
):
    """Lay each tile's (capped) segment of the sorted flat list out at a
    c-aligned start, so K1 reads whole chunks.

    Returns (record table (B, 12 + 3nv, T+1) — setup planes with validity
    baked into e0, then ``attr_rows``; flat_ids (B, l_cap) i32 — the
    triangle of each chunk entry, T for dead lanes; chunk_tile (B, NCH) i32
    — each chunk's tile; start_chunks, n_chunks (B, n_tiles) i32)."""
    s_tri, _, starts, counts = flat
    bsz = s_tri.shape[0]
    t_total = setup.valid.shape[1] - 1
    n_tiles = starts.shape[1]
    dev = s_tri.device

    counts_c = torch.clamp(counts, max=k_cap)
    aligned = (counts_c + (c - 1)) // c * c
    astarts = torch.cumsum(aligned, dim=1, dtype=torch.int32) - aligned
    start_chunks = astarts // c

    nch_total = l_cap // c
    qidx = torch.arange(nch_total, dtype=torch.int32, device=dev)
    qidx = qidx.expand(bsz, nch_total).contiguous()
    chunk_tile = torch.clamp(
        torch.searchsorted(start_chunks, qidx, right=True, out_int32=True) - 1,
        0, n_tiles - 1,
    )
    ct = chunk_tile.long()
    chunk_rank = qidx - torch.gather(start_chunks, 1, ct)
    s_tri_pad = torch.cat(
        [s_tri, torch.full((bsz, c), t_total, dtype=torch.int32, device=dev)],
        dim=1,
    )
    csrc = torch.clamp(
        torch.gather(starts, 1, ct) + chunk_rank * c, 0, s_tri_pad.shape[1] - c
    )
    ccount = torch.gather(counts_c, 1, ct) - chunk_rank * c  # live lanes
    lane = torch.arange(c, dtype=torch.int32, device=dev)
    win = (csrc[..., None] + lane).reshape(bsz, l_cap).long()
    ids2d = torch.gather(s_tri_pad, 1, win).reshape(bsz, nch_total, c)
    flat_ids = torch.where(lane < ccount[..., None], ids2d, t_total)
    flat_ids = flat_ids.reshape(bsz, l_cap)

    # Validity baked into a record copy of e0: dead entries get a = b = 0
    # and g = _BIG_NEG, so they cannot cover after the rebase either.
    p12 = setup.planes12
    valid = setup.valid[:, None]
    e0 = torch.cat(
        [torch.where(valid, p12[:, 0:2], 0.0),
         torch.where(valid, p12[:, 2:3], _BIG_NEG)],
        dim=1,
    )
    table = torch.cat([e0, p12[:, 3:], attr_rows], dim=1)
    return (
        table,
        flat_ids,
        chunk_tile,
        start_chunks,
        (aligned // c).to(torch.int32),
    )


def _flat_chunks_finish(
    rec: torch.Tensor,
    chunk_tile: torch.Tensor,
    n_tx: int,
    tile_w: int,
    tile_h: int,
    c: int,
) -> torch.Tensor:
    """Rebase every gathered record's constants to its tile's origin:
    (B, 12 + 3nv, l_cap) in, K1's ``recs`` out (same rows, each plane's g
    replaced by g + a*ox + b*oy)."""
    bsz, n_rows, l_cap = rec.shape
    nch_total = l_cap // c
    planes = rec.reshape(bsz, n_rows // 3, 3, l_cap)
    a, b, g = planes[:, :, 0], planes[:, :, 1], planes[:, :, 2]

    def origin(v):  # (B, NCH) tile coordinate -> (B, 1, l_cap) pixels
        v = v.to(torch.float32)[..., None].expand(bsz, nch_total, c)
        return v.reshape(bsz, 1, l_cap)

    ox = origin((chunk_tile % n_tx) * tile_w)
    oy = origin((chunk_tile // n_tx) * tile_h)
    g = g + a * ox + b * oy
    return torch.stack([a, b, g], dim=2).reshape(bsz, n_rows, l_cap)


def _k1_inputs(pos, tri, v_attr, height, width, config, pos_world=None,
               mvp=None):
    """Triangle setup, binning and chunk prep for a batch of views: K1's
    inputs ``(recs, flat_ids, start_chunks, n_chunks)`` and its static
    arguments ``(n_vals, tile_h, tile_w, n_ty, n_tx, c)``."""
    tile_h, tile_w = config.tile_h, config.tile_w
    n_ty, n_tx = -(-height // tile_h), -(-width // tile_w)
    n_tiles = n_ty * n_tx
    t_total = tri.shape[0]
    bsz = pos.shape[0]
    n_attr = 0 if v_attr is None else v_attr.shape[-1]
    nv = n_attr + 1 if n_attr > 0 else 1

    c = max(128, (config.chunk // 128) * 128)
    k_cap = min(config.max_tris_per_tile or _auto_cap(t_total, n_tiles), t_total)
    span = config.bin_span_tiles_y * config.bin_span_tiles_x
    l_keys = t_total * span + (
        min(config.bin_huge, t_total) * n_tiles if config.bin_huge > 0 else 0
    )
    if config.bin_med > 0:
        l_keys += (
            min(config.bin_med, t_total)
            * config.bin_med_span_y * config.bin_med_span_x
        )
    if config.bin_flat_cap_factor > 0:
        l_keys = min(l_keys, config.bin_flat_cap_factor * t_total)
    if config.bin_flat_cap_abs > 0:
        l_keys = min(l_keys, config.bin_flat_cap_abs)
    # Upper bound on the sum of c-aligned (capped) segment lengths.
    l_cap = min(l_keys + n_tiles * (c - 1), n_tiles * (-(-k_cap // c) * c))
    l_cap = -(-l_cap // c) * c

    vmajor = tri.T.reshape(-1)
    if pos_world is not None and mvp is not None:
        # World corners gathered once, transformed per view: the same
        # expression as get_clip_space_position, so the same bits.
        wc = pos_world[vmajor]
        v_all = mvp_columns(mvp, wc[:, 0], wc[:, 1], wc[:, 2])
        v_all = v_all.reshape(bsz, 4, 3, t_total)
    else:
        v_all = _clip_corners(pos, tri)

    setup = _triangle_setup_t(v_all, width, height, config.backface_cull)
    flat = _bin_flat(
        setup, width, height, tile_h, tile_w,
        config.bin_span_tiles_y, config.bin_span_tiles_x, config.bin_huge,
        config.bin_flat_cap_factor,
        n_med=config.bin_med, med_span_y=config.bin_med_span_y,
        med_span_x=config.bin_med_span_x,
        cap_abs=config.bin_flat_cap_abs,
        small_cap=config.bin_small_cap,
        cull_margin=_CULL_MARGIN if config.bin_cull else 0.0,
    )
    if v_attr is not None:
        a3 = v_attr[vmajor].T.reshape(n_attr, 3, t_total)
        attr_rows = _attr_planes_t(setup, a3)
    else:
        attr_rows = setup.planes12.new_zeros(bsz, 3, t_total + 1)
    table, flat_ids, chunk_tile, start_chunks, n_chunks = _flat_chunks(
        setup, attr_rows, flat, k_cap, c, l_cap
    )
    rec = torch.gather(
        table, 2, flat_ids.long()[:, None].expand(bsz, table.shape[1], l_cap)
    )
    recs = _flat_chunks_finish(rec, chunk_tile, n_tx, tile_w, tile_h, c)
    return (recs, flat_ids, start_chunks, n_chunks), (nv, tile_h, tile_w,
                                                       n_ty, n_tx, c)


def _gbuffer_dma_batched(
    pos, tri, v_attr, height, width, config, pos_world=None, mvp=None,
):
    """The flat path for a batch of views: chunk prep, then ONE K1 launch
    over the (views, tiles) grid."""
    inputs, dims = _k1_inputs(pos, tri, v_attr, height, width, config,
                              pos_world=pos_world, mvp=mvp)
    z, idm, vals = gbuffer_tiles(*inputs, *dims)
    z = z[:, :height, :width]
    idm = idm[:, :height, :width]
    mask = torch.isfinite(z) & (idm < BACKGROUND_ID)
    z = torch.where(mask, z, 0.0)
    tri_id = torch.where(mask, idm + 1, 0)

    attr = None
    if v_attr is not None:
        vals = vals[:, :, :height, :width]
        den = vals[:, -1]
        den = torch.where(den.abs() < 1e-20, 1e-20, den)
        attr = torch.where(mask[:, None], vals[:, :-1] / den[:, None], 0.0)
        attr = attr.permute(0, 2, 3, 1)
    return mask, z, tri_id, attr


def rasterize_gbuffer(
    pos: torch.Tensor,
    tri: torch.Tensor,
    v_attr: Optional[torch.Tensor],
    resolution: Tuple[int, int],
    config: RasterizerConfig = DEFAULT_CONFIG,
    pos_world: Optional[torch.Tensor] = None,
    mvp: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> GBufferOutput:
    """Fused rasterization + perspective-correct attribute interpolation on
    ``device`` (the card unless ``device="cpu"``; inputs are moved there).

    pos (B, V, 4) clip positions; tri (T, 3); v_attr (V, A) or None.
    ``pos_world`` (V, 3) + ``mvp`` (B, 4, 4): when given, clip corners are
    computed from world corners gathered once. Returns mask / z / tri_id /
    attr.

    Only the flat binned path is ported: meshes below
    ``config.bin_sort_pairs_min_tris`` triangles (or whose int32 sort keys
    would overflow) raise NotImplementedError. Triangle ids are exact int32
    at any count (the JAX package's 2^24 limit comes from its float id
    rows, which this port does not have)."""
    dev = resolve_device(device)
    _check_ported(config)
    height, width = resolution
    pos = pos.to(device=dev, dtype=torch.float32)
    tri = tri.to(device=dev, dtype=torch.long)
    if v_attr is not None:
        v_attr = v_attr.to(device=dev, dtype=torch.float32)
    if pos_world is not None and mvp is not None:
        pos_world = pos_world.to(device=dev, dtype=torch.float32)
        mvp = mvp.to(device=dev, dtype=torch.float32)

    n_tiles = (-(-height // config.tile_h)) * (-(-width // config.tile_w))
    t_total = tri.shape[0]
    use_flat = (
        config.bin_mode == "sort_pairs"
        and t_total >= config.bin_sort_pairs_min_tris
        and (n_tiles + 1) * t_total < 2**31
    )
    if not use_flat:
        raise NotImplementedError(
            "only the flat binned G-buffer path is ported (bin_mode="
            "'sort_pairs' and at least bin_sort_pairs_min_tris triangles); "
            "the per-tile path comes with classic rasterize() "
            "(ROADMAP queue 1 item 8)"
        )
    mask, z, tri_id, attr = _gbuffer_dma_batched(
        pos, tri, v_attr, height, width, config, pos_world=pos_world, mvp=mvp,
    )
    return GBufferOutput(mask=mask, z=z, tri_id=tri_id, attr=attr)
