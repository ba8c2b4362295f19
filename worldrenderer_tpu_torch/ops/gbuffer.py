"""Fused G-buffer rasterization: attributes as screen-affine planes
(PyTorch counterpart of ``worldrenderer_tpu/ops/gbuffer.py``).

Perspective-correct interpolation of a per-vertex attribute is a ratio of
two screen-affine planes, a(p) = [sum_i e_i(p) invw_i a_i] /
[sum_i e_i(p) invw_i]; so coverage, depth, attribute numerators and the
shared denominator are all plane evaluations. Two paths:

* the DMA path (at least ``bin_sort_pairs_min_tris`` triangles, and the
  backend "auto", "fused_pallas" or "pallas"): sorted flat binning, each
  tile's entries laid out as 128-aligned chunks of rebased plane records,
  and kernel K1 (``gbuffer_cuda.py``);
* the per-tile path (every other case): the classic setup, a (3, R*K)
  block of rebased plane rows per tile with a constant id plane, and
  kernel K2, or K3 for ``backend="vpu_pallas"`` (``zattr_cuda.py``). At
  scale the rows come from the same flat binning, each tile's window of
  the sorted list; below it from dense per-tile binning.
This is the JAX package's routing: its ``_gbuffer_core`` takes the DMA
path for ``fused_pallas`` alone, and its per-tile path evaluates
``fused_xla`` with ``_zattr_tile_xla``, whose contract is K2's.

With ``bin_tiny_px`` > 0, both paths at scale leave the sub-pixel
triangles out of the binning and rasterize them by sorting instead
(:func:`_tiny_images`, torch ops as the JAX package's are XLA sorts), then
merge the two images by nearest z and least id (:func:`_merge_zidvals`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._device import _I32_MAX, DeviceLike, resolve_device, to_int32_sat
from ..transforms import mvp_columns
from ..utils.debug import annotate, count
from .gbuffer_cuda import BACKGROUND_ID, gbuffer_tiles
from .rasterize import (
    DEFAULT_CONFIG,
    RasterizerConfig,
    _auto_cap,
    _bin_flat,
    _bin_triangles,
    _check_ported,
    _classic_layout,
    _clip_corners,
    _check_tiny_px,
    _CULL_MARGIN,
    _detile,
    _gather_tile_rows,
    _gather_tile_rows_flat,
    _K1_BACKENDS,
    _tile_origins,
    _tiny_mask,
    _triangle_setup_t,
    _TriSetup,
    _TriSetupT,
    _use_flat,
)
from .tensor import BIG_NEG, chunk_size, fma_dot3
from .zattr_cuda import zattr_tiles, zattr_tiles_vpu

__all__ = ["rasterize_gbuffer", "GBufferOutput"]

class GBufferOutput(NamedTuple):
    mask: torch.Tensor  # (B, H, W) bool
    z: torch.Tensor  # (B, H, W) f32 NDC depth (0 where background)
    tri_id: torch.Tensor  # (B, H, W) i32 triangle_id + 1, 0 = background
    attr: Optional[torch.Tensor]  # (B, H, W, A) perspective-correct attrs


def _uv_corner_attrs_t(t_total: int, device=None) -> torch.Tensor:
    """Per-corner one-hot attributes (2, 3, T) whose perspective-correct
    interpolation is the nvdiffrast (u, v): the barycentrics of local
    vertices 1 and 2."""
    count("host_sync.uv_corners")  # a copy from the host
    eye = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], device=device)
    return eye[:, :, None].expand(2, 3, t_total)


def _attr_planes(setup: _TriSetup, a: torch.Tensor) -> torch.Tensor:
    """Numerator planes of each attribute channel plus the shared
    denominator plane in the classic layout: (B, T+1, A+1, 3), denominator
    last. ``a`` (T, 3, A) per-corner values. Rounded as the reference's
    fp32 ``einsum`` contractions at ``Precision.HIGHEST`` round on the CPU:
    q_i = inv_w_i * e_i first, then ``fma(a2, q2, fma(a1, q1, a0 * q0))``,
    and the denominator ``fma(w2, e2, fma(w1, e1, w0 * e0))``."""
    inv_w = setup.inv_w[:, :-1]  # (B, T, 3)
    ep = setup.planes[:, :-1, :3, :]  # (B, T, 3 edges, 3 coefs)
    q = inv_w[..., None] * ep  # (B, T, 3, 3)
    num = fma_dot3(a[None, :, :, :, None], q[:, :, :, None, :], 2)  # (B, T, A, 3)
    den = fma_dot3(inv_w[..., None], ep, 2)  # (B, T, 3)
    planes = torch.cat([num, den[:, :, None]], dim=2)
    return torch.cat([planes, planes.new_zeros(planes[:, :1].shape)], dim=1)


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


# ---- The sub-pixel sort path (RasterizerConfig.bin_tiny_px) -----------------
# int32's largest value is its sentinel z bits and triangle id.


def _z_sort_bits(z: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of float32 bits to int32 (signed compare):
    -0.0 maps below +0.0. Applied twice it restores the bits."""
    b = z.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)  # >> on int32 is arithmetic


def _z_from_sort_bits(zb: torch.Tensor) -> torch.Tensor:
    """The float32 z of :func:`_z_sort_bits`' int32 value."""
    zb = zb.to(torch.int32).contiguous()
    return (zb ^ ((zb >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _tiny_candidates(rows12, bbox4, tiny, height, width, tile_h, tile_w):
    """Each tiny triangle's one pixel-centre candidate. rows12 (B, 12, T+1)
    setup planes, bbox4 (B, 4, T+1), tiny (B, T) the triangles this path
    owns. Returns pix (B, T) int32, the row-major pixel (H*W where the
    candidate misses, lies off screen or fails the edge or depth test),
    and z (B, T), its depth (meaningless where pix is H*W). One definition
    of a covered candidate for the path and for binning_stats' guard.

    A bbox under 1 px per axis holds at most one pixel centre per axis:
    the first centre at or above the bbox minimum. The planes are
    evaluated as the tile kernels evaluate them, rebased to the pixel's
    tile origin, in the order ``a*lx + b*ly + (c + a*ox + b*oy)``."""
    hw = height * width
    xmin, xmax, ymin, ymax = (bbox4[:, k, :-1] for k in range(4))
    pxf = torch.ceil(xmin - 0.5) + 0.5
    pyf = torch.ceil(ymin - 0.5) + 0.5
    ix = to_int32_sat(pxf - 0.5)
    iy = to_int32_sat(pyf - 0.5)
    inb = ((pxf <= xmax) & (pyf <= ymax) & (ix >= 0) & (ix < width)
           & (iy >= 0) & (iy < height))
    oxf = (torch.div(ix, tile_w, rounding_mode="floor") * tile_w).to(torch.float32)
    oyf = (torch.div(iy, tile_h, rounding_mode="floor") * tile_h).to(torch.float32)
    lxf = pxf - oxf  # exact: small integers + 0.5
    lyf = pyf - oyf

    def ev(r):
        a, b, c = rows12[:, r, :-1], rows12[:, r + 1, :-1], rows12[:, r + 2, :-1]
        return a * lxf + b * lyf + (c + a * oxf + b * oyf)

    e0, e1, e2, z = ev(0), ev(3), ev(6), ev(9)
    cov = (tiny & inb & (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
           & (z >= -1.0) & (z <= 1.0))
    pix = torch.where(cov, iy * width + ix, hw)
    return pix, z


def _tiny_images(rows12, attr_rows, bbox4, tiny, height, width, tile_h,
                 tile_w, cap=0):
    """Sort-path rasterization of the sub-pixel triangles ``tiny`` (B, T).

    Each emits at most one (pixel, z, id) candidate. One stable sort per
    view of the int64 key ``pix << 32 | (zb + 2^31)``, zb the z's
    :func:`_z_sort_bits`, over the candidates in ascending id and then one
    sentinel per pixel (zb = id = int32 max), orders them by (pixel, z,
    id): the reference's three-key sort. Every pixel owns a sentinel, so
    each pixel group is non-empty and its first entry is the pixel's
    winner, nearest z then least id; a binary search for each pixel's group
    start reads the image out.

    ``cap`` (``bin_tiny_cap``, 0 off, ignored at T or more): only the first
    ``cap`` covered candidates in ascending id enter the sort; the same
    image while the cap holds them all, and an overflow drops the highest
    ids, as the reference does.

    Returns z (B, H, W) +inf on background, idm (B, H, W) int32 with
    ``BACKGROUND_ID`` on background, and with ``attr_rows`` (B, 3(A+1),
    T+1) the winners' attribute planes evaluated at each pixel (B, A+1, H,
    W) (:func:`_tiny_finish`), else None."""
    bsz, t_total = tiny.shape
    hw = height * width
    dev = tiny.device
    pix, z = _tiny_candidates(rows12, bbox4, tiny, height, width, tile_h,
                              tile_w)
    zb = torch.where(pix < hw, _z_sort_bits(z), _I32_MAX)
    tid = torch.arange(t_total, dtype=torch.int32, device=dev).expand(bsz, -1)
    if 0 < cap < t_total:
        # Ascending covered ids: each covered candidate's rank among them is
        # its slot; the rest (and ranks past the cap) go to a spare slot.
        cov = pix < hw
        rank = torch.cumsum(cov, dim=1) - 1
        slot = torch.where(cov & (rank < cap), rank, cap)
        sid = torch.full((bsz, cap + 1), t_total, dtype=torch.int32, device=dev)
        sid = sid.scatter(1, slot, tid)[:, :cap]
        live = sid < t_total
        sidx = torch.clamp(sid, max=t_total - 1).long()
        pix = torch.where(live, torch.gather(pix, 1, sidx), hw)
        zb = torch.where(live, torch.gather(zb, 1, sidx), _I32_MAX)
        tid = torch.where(live, sid, _I32_MAX)
    pixels = torch.arange(hw, dtype=torch.int64, device=dev).expand(bsz, -1)
    pix_all = torch.cat([pix.long(), pixels], dim=1)
    zb_all = torch.cat([zb.long(), torch.full((bsz, hw), _I32_MAX, device=dev)],
                       dim=1)
    tid_all = torch.cat(
        [tid, torch.full((bsz, hw), _I32_MAX, dtype=torch.int32, device=dev)],
        dim=1)
    key, order = torch.sort((pix_all << 32) | (zb_all + 2**31), dim=1,
                            stable=True)
    first = torch.searchsorted(key >> 32, pixels.contiguous())
    zb_img = (torch.gather(key, 1, first) & 0xFFFFFFFF) - 2**31
    tid_img = torch.gather(tid_all, 1, torch.gather(order, 1, first))
    bg = tid_img == _I32_MAX
    z_img = torch.where(bg, torch.inf, _z_from_sort_bits(zb_img))
    idm = torch.where(bg, BACKGROUND_ID, tid_img).to(torch.int32)
    vals = None
    if attr_rows is not None:
        # Background pixels read the zero padding row T.
        row = torch.where(bg, t_total, tid_img).long()
        g = torch.gather(attr_rows, 2,
                         row[:, None].expand(bsz, attr_rows.shape[1], hw))
        vals = _tiny_finish(g, height, width, tile_h, tile_w)
    return (z_img.reshape(bsz, height, width), idm.reshape(bsz, height, width),
            vals)


def _tiny_finish(g, height, width, tile_h, tile_w):
    """The winners' attribute planes g (B, 3(A+1), H*W), rows [val0_a,
    val0_b, val0_g, val1_a, ...], evaluated at each pixel centre, rebased
    to its tile origin in the candidate test's order: (B, A+1, H, W)."""
    bsz = g.shape[0]
    p = torch.arange(height * width, device=g.device)
    px_i, py_i = p % width, p // width
    ox = (px_i // tile_w * tile_w).to(torch.float32)
    oy = (py_i // tile_h * tile_h).to(torch.float32)
    lx = px_i.to(torch.float32) + 0.5 - ox
    ly = py_i.to(torch.float32) + 0.5 - oy
    a, b, c = g[:, 0::3], g[:, 1::3], g[:, 2::3]
    vals = a * lx + b * ly + (c + a * ox + b * oy)
    return vals.reshape(bsz, -1, height, width)


def _merge_zidvals(z_a, idm_a, vals_a, z_b, idm_b, vals_b):
    """Merge two (z, id, vals) image sets by nearest z, least id on an
    exact z tie (-0 == +0 here, so the id decides). Backgrounds carry
    z = +inf and the background id in both. vals (B, C, H, W) are merged
    where both are given, else ``vals_a`` is returned."""
    take_b = (z_b < z_a) | ((z_b == z_a) & (idm_b < idm_a))
    z = torch.where(take_b, z_b, z_a)
    idm = torch.where(take_b, idm_b, idm_a)
    vals = vals_a
    if vals_a is not None and vals_b is not None:
        vals = torch.where(take_b[:, None], vals_b, vals_a)
    return z, idm, vals


def _tiny_for(setup: _TriSetupT, attr_rows, height, width, config):
    """The sort path's images for ``config.bin_tiny_px`` > 0 (else None)."""
    if config.bin_tiny_px <= 0:
        return None
    return _tiny_images(
        setup.planes12, attr_rows, setup.bbox4,
        _tiny_mask(setup, config.bin_tiny_px), height, width, config.tile_h,
        config.tile_w, cap=config.bin_tiny_cap,
    )


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
    # and g = BIG_NEG, so they cannot cover after the rebase either.
    p12 = setup.planes12
    valid = setup.valid[:, None]
    e0 = torch.cat(
        [torch.where(valid, p12[:, 0:2], 0.0),
         torch.where(valid, p12[:, 2:3], BIG_NEG)],
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
    sub: int = 1,
) -> torch.Tensor:
    """Rebase every gathered record's constants to its tile's origin:
    (B, 12 + 3nv, l_cap) in, K1's ``recs`` out (same rows, each plane's g
    replaced by g + a*ox + b*oy).

    ``sub`` > 1 (``bin_subtile``): ``chunk_tile`` indexes band bins, ``sub``
    band rows to a tile row, and the rebase stays at the output TILE's
    origin (``tile_h`` its height): a band origin would change every
    pixel's float expression, and K1 offsets each band's ly instead."""
    bsz, n_rows, l_cap = rec.shape
    nch_total = l_cap // c
    planes = rec.reshape(bsz, n_rows // 3, 3, l_cap)
    a, b, g = planes[:, :, 0], planes[:, :, 1], planes[:, :, 2]

    def origin(v):  # (B, NCH) tile coordinate -> (B, 1, l_cap) pixels
        v = v.to(torch.float32)[..., None].expand(bsz, nch_total, c)
        return v.reshape(bsz, 1, l_cap)

    ox = origin((chunk_tile % n_tx) * tile_w)
    rows = chunk_tile // n_tx
    oy = origin((rows // sub if sub > 1 else rows) * tile_h)
    g = g + a * ox + b * oy
    return torch.stack([a, b, g], dim=2).reshape(bsz, n_rows, l_cap)


def _k1_inputs(pos, tri, v_attr, height, width, config, pos_world=None,
               mvp=None, tri_attr=None, uv_mode=False):
    """Triangle setup, binning and chunk prep for a batch of views: K1's
    inputs ``(recs, flat_ids, start_chunks, n_chunks)``, its static
    arguments ``(n_vals, tile_h, tile_w, n_ty, n_tx, c, sub)``, and third
    the sort path's images (:func:`_tiny_images`) with ``bin_tiny_px`` on,
    else None. ``tri_attr`` (T, 3): corner indices into ``v_attr`` where its
    topology differs from ``tri``; ``uv_mode``: the attributes are the
    (u, v) barycentrics.

    ``bin_subtile`` = sub > 1 bins at bands of tile_h / sub rows over the
    padded tile grid (spans in band units), one (start, count) pair per
    band in band-row-major order; the output stays at tile granularity."""
    _check_tiny_px(config)
    tile_h, tile_w = config.tile_h, config.tile_w
    sub = config.bin_subtile
    if sub < 1 or tile_h % sub:
        raise ValueError(
            f"bin_subtile ({sub}) must be >= 1 and divide tile_h ({tile_h})"
        )
    n_ty, n_tx = -(-height // tile_h), -(-width // tile_w)
    # The band bins tile the padded output grid: every tile owns sub bins.
    n_bins = n_ty * n_tx * sub
    bin_height = n_ty * tile_h if sub > 1 else height
    t_total = tri.shape[0]
    bsz = pos.shape[0]
    if uv_mode:
        n_attr = 2
    else:
        n_attr = 0 if v_attr is None else v_attr.shape[-1]
    nv = n_attr + 1 if n_attr > 0 else 1

    c = chunk_size(config.chunk)
    k_cap = min(config.max_tris_per_tile or _auto_cap(t_total, n_bins), t_total)
    span = config.bin_span_tiles_y * config.bin_span_tiles_x
    l_keys = t_total * span + (
        min(config.bin_huge, t_total) * n_bins if config.bin_huge > 0 else 0
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
    l_cap = min(l_keys + n_bins * (c - 1), n_bins * (-(-k_cap // c) * c))
    l_cap = -(-l_cap // c) * c

    vmajor = tri.T.reshape(-1)
    with annotate("wr::raster.setup"):
        if pos_world is not None and mvp is not None:
            # World corners gathered once, transformed per view: the same
            # expression as get_clip_space_position, so the same bits.
            wc = pos_world[vmajor]
            v_all = mvp_columns(mvp, wc[:, 0], wc[:, 1], wc[:, 2])
            v_all = v_all.reshape(bsz, 4, 3, t_total)
        else:
            v_all = _clip_corners(pos, tri)
        setup = _triangle_setup_t(v_all, width, height, config.backface_cull)
    with annotate("wr::raster.bin"):
        flat = _bin_flat_config(setup, width, bin_height, config,
                                tile_h=tile_h // sub)
    with annotate("wr::raster.chunks"):
        if uv_mode:
            attr_rows = _attr_planes_t(setup,
                                       _uv_corner_attrs_t(t_total, pos.device))
        elif v_attr is not None:
            am = vmajor if tri_attr is None else tri_attr.T.reshape(-1)
            a3 = v_attr[am].T.reshape(n_attr, 3, t_total)
            attr_rows = _attr_planes_t(setup, a3)
        else:
            attr_rows = setup.planes12.new_zeros(bsz, 3, t_total + 1)
        table, flat_ids, chunk_tile, start_chunks, n_chunks = _flat_chunks(
            setup, attr_rows, flat, k_cap, c, l_cap
        )
        rec = torch.gather(
            table, 2, flat_ids.long()[:, None].expand(bsz, table.shape[1], l_cap)
        )
        recs = _flat_chunks_finish(rec, chunk_tile, n_tx, tile_w, tile_h, c, sub)
        tiny = _tiny_for(setup, attr_rows if n_attr > 0 else None, height,
                         width, config)
    return ((recs, flat_ids, start_chunks, n_chunks),
            (nv, tile_h, tile_w, n_ty, n_tx, c, sub), tiny)


def _bin_flat_config(setup, width, height, config, tile_h=None):
    """:func:`_bin_flat` with ``config``'s tiles (bins of ``tile_h`` rows
    where given), tiers, caps and cull."""
    return _bin_flat(
        setup, width, height, tile_h or config.tile_h, config.tile_w,
        config.bin_span_tiles_y, config.bin_span_tiles_x, config.bin_huge,
        config.bin_flat_cap_factor,
        n_med=config.bin_med, med_span_y=config.bin_med_span_y,
        med_span_x=config.bin_med_span_x,
        cap_abs=config.bin_flat_cap_abs,
        small_cap=config.bin_small_cap,
        tiny_px=config.bin_tiny_px,
        cull_margin=_CULL_MARGIN if config.bin_cull else 0.0,
    )


def _attr_from_vals(vals, mask):
    """(B, A+1, H, W) numerators and denominator -> (B, H, W, A) attributes,
    0 where ``mask`` is False."""
    den = vals[:, -1]
    den = torch.where(den.abs() < 1e-20, 1e-20, den)
    attr = torch.where(mask[:, None], vals[:, :-1] / den[:, None], 0.0)
    return attr.permute(0, 2, 3, 1)


def _gbuffer_dma_batched(
    pos, tri, v_attr, height, width, config, pos_world=None, mvp=None,
    tri_attr=None, uv_mode=False,
):
    """The flat path for a batch of views: chunk prep, then ONE K1 launch
    over the (views, tiles) grid, merged with the sort path's images when
    ``bin_tiny_px`` is on."""
    inputs, dims, tiny = _k1_inputs(pos, tri, v_attr, height, width, config,
                                    pos_world=pos_world, mvp=mvp,
                                    tri_attr=tri_attr, uv_mode=uv_mode)
    z, idm, vals = gbuffer_tiles(*inputs, *dims)
    with annotate("wr::raster.resolve"):
        z = z[:, :height, :width]
        idm = idm[:, :height, :width]
        vals = vals[:, :, :height, :width]
        if tiny is not None:
            z, idm, vals = _merge_zidvals(z, idm, vals, *tiny)
        mask = torch.isfinite(z) & (idm < BACKGROUND_ID)
        z = torch.where(mask, z, 0.0)
        tri_id = torch.where(mask, idm + 1, 0)

        attr = None
        if v_attr is not None or uv_mode:
            attr = _attr_from_vals(vals, mask)
    return mask, z, tri_id, attr


def _zattr_inputs(pos, tri, v_attr, height, width, config, tri_attr=None,
                  uv_mode=False):
    """Classic setup, a constant id plane (a = b = 0, g = triangle id) beside
    the attribute planes, binning and the tile row gather for a batch of
    views: K2's and K3's inputs ``(coeffs, counts)``, their static
    arguments ``(n_vals, tile_h, tile_w, chunk)``, and third the sort
    path's images (:func:`_tiny_images`) at scale with ``bin_tiny_px`` on,
    else None. At scale (:func:`_use_flat`) the rows are windows of
    ``k_cap`` entries of the flat binning, below it dense per-tile lists;
    ``k_cap`` is ``max_tris_per_tile`` (or the automatic cap) and at most
    T. ``uv_mode``: the attributes are the (u, v) barycentrics."""
    _check_tiny_px(config)
    bsz, t_total = pos.shape[0], tri.shape[0]
    if t_total >= 2**24:
        raise ValueError(
            f"the per-tile path's f32 id plane is exact below 2^24 triangles "
            f"(got {t_total}); use backend='fused_pallas' or decimate first")
    dev = pos.device
    tile_h, tile_w = config.tile_h, config.tile_w
    n_ty, n_tx = -(-height // tile_h), -(-width // tile_w)
    with annotate("wr::raster.setup"):
        setup_t = _triangle_setup_t(_clip_corners(pos, tri), width, height,
                                    config.backface_cull, z_dot=True)
        setup = _classic_layout(setup_t)
        id_plane = torch.zeros((bsz, t_total + 1, 1, 3), device=dev)
        id_plane[..., 0, 2] = torch.arange(t_total + 1, dtype=torch.float32,
                                           device=dev)
        if uv_mode:
            n_attr = 2
            attr_planes = _attr_planes(
                setup, _uv_corner_attrs_t(t_total, dev).permute(2, 1, 0))
        elif v_attr is not None:
            n_attr = v_attr.shape[-1]
            attr_planes = _attr_planes(setup, v_attr[tri if tri_attr is None
                                                     else tri_attr])
        else:
            n_attr = 0
            attr_planes = torch.zeros((bsz, t_total + 1, 1, 3), device=dev)
        all_planes = torch.cat([setup.planes, id_plane, attr_planes], dim=2)
    k_cap = min(config.max_tris_per_tile or _auto_cap(t_total, n_ty * n_tx),
                t_total)
    tiny = None
    if _use_flat(config, t_total, n_ty * n_tx):
        with annotate("wr::raster.bin"):
            flat = _bin_flat_config(setup_t, width, height, config)
        with annotate("wr::raster.chunks"):
            coeffs, counts = _gather_tile_rows_flat(
                all_planes, setup.valid, flat, k_cap, n_tx, tile_w, tile_h)
            attr_rows = None
            if n_attr > 0:
                attr_rows = all_planes[:, :, 5:].reshape(bsz, t_total + 1, -1)
                attr_rows = attr_rows.transpose(1, 2)
            tiny = _tiny_for(setup_t, attr_rows, height, width, config)
    else:
        with annotate("wr::raster.bin"):
            ids, counts = _bin_triangles(setup, width, height, tile_h, tile_w,
                                         k_cap)
        with annotate("wr::raster.chunks"):
            origins = _tile_origins(n_ty, n_tx, tile_h, tile_w, dev)
            coeffs = _gather_tile_rows(all_planes, setup.valid, ids, origins)
            counts = counts.reshape(-1)
    return (coeffs, counts), (n_attr + 1, tile_h, tile_w, config.chunk), tiny


def _gbuffer_single(pos, tri, v_attr, height, width, config, tri_attr=None,
                    uv_mode=False):
    """The per-tile path for a batch of views (the JAX package's per-view
    ``_gbuffer_single``): the tile rows of :func:`_zattr_inputs`, then ONE
    launch of K2 — or K3 for ``backend="vpu_pallas"`` — over every (view,
    tile), merged with the sort path's images when ``bin_tiny_px`` is on at
    scale."""
    tile_h, tile_w = config.tile_h, config.tile_w
    n_ty, n_tx = -(-height // tile_h), -(-width // tile_w)
    bsz = pos.shape[0]
    inputs, dims, tiny = _zattr_inputs(pos, tri, v_attr, height, width,
                                       config, tri_attr=tri_attr,
                                       uv_mode=uv_mode)
    kernel = zattr_tiles_vpu if config.backend == "vpu_pallas" else zattr_tiles
    z_t, id_t, v_t = kernel(*inputs, *dims)
    with annotate("wr::raster.resolve"):
        z = _detile(z_t, bsz, n_ty, n_tx, height, width)
        tid = _detile(id_t, bsz, n_ty, n_tx, height, width)
        vals = _detile(v_t, bsz, n_ty, n_tx, height, width)
        if tiny is not None:
            z_b, id_b, vals_b = tiny
            z, tid, vals = _merge_zidvals(z, tid, vals, z_b,
                                          id_b.to(torch.float32), vals_b)
        mask = torch.isfinite(z) & (tid < BACKGROUND_ID)
        z = torch.where(mask, z, 0.0)
        tri_id = torch.where(mask, tid.to(torch.int32) + 1, 0)
        attr = None
        if v_attr is not None or uv_mode:
            attr = _attr_from_vals(vals, mask)
    return mask, z, tri_id, attr


def _gbuffer_core(pos, tri, v_attr, height, width, config, tri_attr=None,
                  pos_world=None, mvp=None):
    """The DMA path (K1) at scale for the K1 backends, else the per-tile
    path."""
    n_tiles = (-(-height // config.tile_h)) * (-(-width // config.tile_w))
    # K1 bins at bin_subtile bands: its key space counts them.
    n_bins = n_tiles * max(config.bin_subtile, 1)
    if (config.backend in _K1_BACKENDS
            and _use_flat(config, tri.shape[0], n_bins)):
        return _gbuffer_dma_batched(
            pos, tri, v_attr, height, width, config, pos_world=pos_world,
            mvp=mvp, tri_attr=tri_attr,
        )
    return _gbuffer_single(pos, tri, v_attr, height, width, config,
                           tri_attr=tri_attr)


def rasterize_gbuffer(
    pos: torch.Tensor,
    tri: torch.Tensor,
    v_attr: Optional[torch.Tensor],
    resolution: Tuple[int, int],
    config: RasterizerConfig = DEFAULT_CONFIG,
    tri_attr: Optional[torch.Tensor] = None,
    pos_world: Optional[torch.Tensor] = None,
    mvp: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> GBufferOutput:
    """Fused rasterization + perspective-correct attribute interpolation on
    ``device`` (the card unless ``device="cpu"``; inputs are moved there).

    pos (B, V, 4) clip positions; tri (T, 3); v_attr (V, A) or None.
    ``tri_attr`` (T, 3): corner indices for v_attr where the attribute
    topology differs from the rasterized one. ``pos_world`` (V, 3) +
    ``mvp`` (B, 4, 4): when given, the flat path computes clip corners from
    world corners gathered once. Returns mask / z / tri_id / attr.

    At least ``config.bin_sort_pairs_min_tris`` triangles (and int32 sort
    keys) take the flat binning; there the backends "auto", "fused_pallas"
    and "pallas" run K1, as the JAX package's ``fused_pallas`` runs its DMA
    kernel. Every other case runs the per-tile path: K3 for
    ``backend="vpu_pallas"``, K2 for the rest, on flat-binned tile rows at
    scale. Triangle ids are exact int32 in K1 at any count (the JAX
    package's 2^24 limit comes from its float id rows, which K1 here does
    not have); K2's and K3's constant id plane is f32, exact below 2^24."""
    dev = resolve_device(device)
    _check_ported(config)
    height, width = resolution
    pos = pos.to(device=dev, dtype=torch.float32)
    tri = tri.to(device=dev, dtype=torch.long)
    if v_attr is not None:
        v_attr = v_attr.to(device=dev, dtype=torch.float32)
    if tri_attr is not None:
        tri_attr = tri_attr.to(device=dev, dtype=torch.long)
    if pos_world is not None and mvp is not None:
        pos_world = pos_world.to(device=dev, dtype=torch.float32)
        mvp = mvp.to(device=dev, dtype=torch.float32)
    mask, z, tri_id, attr = _gbuffer_core(
        pos, tri, v_attr, height, width, config, tri_attr=tri_attr,
        pos_world=pos_world, mvp=mvp,
    )
    return GBufferOutput(mask=mask, z=z, tri_id=tri_id, attr=attr)
