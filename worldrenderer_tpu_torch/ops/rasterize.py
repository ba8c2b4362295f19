"""Rasterizer configuration, triangle setup, tile binning and the classic
nvdiffrast-style API (PyTorch counterpart of
``worldrenderer_tpu/ops/rasterize.py``).

Every function here takes the view batch as a written-out leading
dimension B. Screen-space planes, bboxes and binning follow the JAX
package expression by expression, so one ``RasterizerConfig`` drives both
packages and binning lists come out equal. Elementwise arithmetic is
separately rounded fp32 (PyTorch fuses no multiply-add), which keeps the
CPU and the card bit-identical and equal to the JAX package run op by op;
jitted, XLA on the CPU contracts ``a * b + c`` into FMAs, so the jitted
reference differs in the last bit of some planes. Where the reference
contracts with an fp32 dot (``einsum`` at ``Precision.HIGHEST``), the port
rounds as that dot does, through ``transforms.fma_f32``.

``rasterize`` returns (B, H, W, 4) channels (u, v, z/w, triangle_id + 1),
0 on background: below ``bin_sort_pairs_min_tris`` triangles through the
classic setup, dense per-tile binning and kernel K4
(``raster_zid_cuda.py``), above it through the flat G-buffer path and
kernel K1 in uv mode (K2 for the "xla" backends, as the JAX package routes
them). ``rasterize_diff`` returns the same values with gradients of
(u, v, z/w) w.r.t. the clip positions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device, to_int32_sat
from ..utils.debug import annotate, count
from .raster_zid_cuda import raster_zid_tiles
from .tensor import BIG_NEG, edge0_pad_block, fma_dot3

__all__ = [
    "RasterizerConfig", "DEFAULT_CONFIG", "FAST_TPU_CONFIG",
    "binning_stats", "auto_fast_config", "rasterize", "rasterize_db",
    "rasterize_diff",
]

_W_EPS = 1e-8


class RasterizerConfig(NamedTuple):
    """Static tuning knobs; every field, name and default of the JAX
    package's ``RasterizerConfig``, so one config drives both packages.

    On this port:
      * ``dot_precision`` (any value) and ``sel_pack`` mean exact fp32
        evaluation — there is no matrix unit in the coverage test;
      * ``kernel_unroll``, ``dma_group``, ``cov_mode``, ``winner_mode`` and
        ``chunk_slice_mode`` are accepted and ignored (bit-identical knobs
        of the TPU kernel);
      * ``bin_subtile`` = s > 1 bins the K1 route at (tile_h / s)-row bands
        (s must divide ``tile_h`` there) and is bit-identical to s = 1
        while the budgets are lossless; every other route ignores it, as
        the JAX package's do;
      * ``bin_tiny_px`` (at most 1.0) sends sub-pixel triangles through the
        sort path of ``gbuffer.py`` wherever the JAX package does: the fused
        G-buffer paths and classic ``rasterize`` at scale; below
        ``bin_sort_pairs_min_tris`` triangles the classic path ignores it;
      * ``backend`` takes the JAX package's names and picks the kernel
        (see ``_BACKEND_NAMES``); each kernel's wrapper picks the CUDA
        kernel or its plain version by the tensors' device.
    Field meanings are documented on the JAX package's config."""

    tile_h: int = 32
    tile_w: int = 128
    chunk: int = 128
    max_tris_per_tile: Optional[int] = None
    backend: str = "auto"
    bin_mode: str = "sort_pairs"
    bin_span_tiles_y: int = 4
    bin_span_tiles_x: int = 2
    bin_huge: int = 256
    bin_sort_pairs_min_tris: int = 4096
    bin_med: int = 0
    bin_med_span_y: int = 8
    bin_med_span_x: int = 4
    bin_flat_cap_factor: int = 4
    dot_precision: str = "highest"
    chunk_slice_mode: str = "shift"
    kernel_unroll: int = 1
    winner_mode: str = "dot"
    sel_pack: bool = False
    bin_tiny_px: float = 0.0
    bin_flat_cap_abs: int = 0
    bin_small_cap: int = 0
    bin_tiny_cap: int = 0
    bin_subtile: int = 1
    dma_group: int = 1
    cov_mode: str = "cmp"
    bin_cull: bool = False
    backface_cull: int = 0


DEFAULT_CONFIG = RasterizerConfig()

# n_tiles * K entry budget for max_tris_per_tile=None (the JAX package's
# _AUTO_TILE_ENTRY_BUDGET).
_AUTO_TILE_ENTRY_BUDGET = 16 * 2**20


def _auto_cap(t_total: int, n_tiles: int) -> int:
    return int(
        min(t_total, max(2048, _AUTO_TILE_ENTRY_BUDGET // max(n_tiles, 1)))
    )


# The JAX package's backend names, routed as the JAX package routes them
# on its accelerator ("auto" as "fused_pallas" / "pallas"):
#   * rasterize_gbuffer() (render()'s fused branch): K3 for "vpu_pallas";
#     K1 on the flat path (at least bin_sort_pairs_min_tris triangles) for
#     the _K1_BACKENDS; K2 for every other case, on flat-binned tile rows
#     at scale and on dense ones below it;
#   * rasterize(): on the flat path K1 in uv mode, but for the _XLA_BACKENDS
#     K2 in uv mode on flat-binned rows; below it K4 for every name;
#   * render() takes its fused branch for "auto", "fused_pallas" and
#     "fused_xla" and the classic rasterize() + interpolate() branch for
#     the rest.
# Each kernel's wrapper picks the CUDA kernel or its plain version by the
# tensors' device.
_BACKEND_NAMES = ("auto", "fused_pallas", "fused_xla", "vpu_pallas", "pallas",
                  "xla")
_K1_BACKENDS = ("auto", "fused_pallas", "pallas")
_XLA_BACKENDS = ("xla", "fused_xla")


def _check_ported(config: RasterizerConfig) -> None:
    """Raise on an unknown backend name."""
    if config.backend not in _BACKEND_NAMES:
        raise ValueError(f"unknown backend {config.backend!r}")


def _check_tiny_px(config: RasterizerConfig) -> None:
    """The sort path's exactness bound, checked where the JAX package's
    G-buffer paths check it."""
    if config.bin_tiny_px > 1.0:
        raise ValueError(
            "bin_tiny_px must be <= 1.0 (a 1 px bbox is the single-"
            "candidate exactness bound)"
        )


# Tuned fast path: the same values as the JAX package's FAST_TPU_CONFIG.
FAST_TPU_CONFIG = RasterizerConfig(
    tile_h=16, max_tris_per_tile=1536, backend="fused_pallas", chunk=128,
    dot_precision="split_bf16", winner_mode="vpu", sel_pack=True,
    bin_flat_cap_factor=2, bin_huge=64, bin_span_tiles_y=2,
    bin_span_tiles_x=2, bin_med=512, bin_cull=True,
)


class _TriSetupT(NamedTuple):
    """Per-triangle screen-space planes, triangles on the last dim, with a
    trailing padded slot T (valid=False) that binned id lists pad with.

    ``planes12`` rows are [e0_a, e0_b, e0_g, e1_a, ..., z_a, z_b, z_g]:
    edge/depth value ``a * px + b * py + g`` with px, py in pixel units
    (pixel centres at +0.5)."""

    planes12: torch.Tensor  # (B, 12, T+1) f32
    inv_w: torch.Tensor  # (B, 3, T+1)
    inv_area: torch.Tensor  # (B, T+1)
    valid: torch.Tensor  # (B, T+1) bool
    bbox4: torch.Tensor  # (B, 4, T+1) rows xmin, xmax, ymin, ymax


def _clip_corners(pos_clip: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """(B, V, 4) clip positions -> (B, 4, 3, T) vertex-major corners."""
    t_total = tri.shape[0]
    v = pos_clip[:, tri.T.reshape(-1)]  # (B, 3T, 4)
    return v.permute(0, 2, 1).reshape(pos_clip.shape[0], 4, 3, t_total)


def _pad_last(a: torch.Tensor, fill=0.0) -> torch.Tensor:
    pad = torch.full(a.shape[:-1] + (1,), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=-1)


def _triangle_setup_t(
    v4: torch.Tensor,
    width: int,
    height: int,
    backface_cull: int = 0,
    z_dot: bool = False,
) -> _TriSetupT:
    """Triangle setup for every view. ``v4`` (B, 4, 3, T): clip positions,
    vertex-major (see :func:`_clip_corners`).

    Near-plane-crossing triangles get clipless homogeneous planes (the
    cofactors of [x*w; y*w; w]) and a conservative bbox; ``backface_cull``
    +1 / -1 drops screen-clockwise / counter-clockwise non-crossing
    triangles (with the negated-Y projection, -1 culls the back faces of
    outward-CCW meshes). ``z_dot``: round the z plane as the classic
    setup's ``einsum`` does (``tensor.fma_dot3``) instead of as separately
    rounded products and sums."""
    nxt = [1, 2, 0]
    prv = [2, 0, 1]
    w = v4[:, 3]  # (B, 3, T)
    front = (w > _W_EPS).all(dim=1)
    crossing = (w > _W_EPS).any(dim=1) & ~front
    w_safe = torch.where(w.abs() < _W_EPS, _W_EPS, w)
    inv_w = 1.0 / w_safe
    x = (v4[:, 0] * inv_w + 1.0) * (width * 0.5)  # (B, 3, T)
    y = (v4[:, 1] * inv_w + 1.0) * (height * 0.5)
    zw = v4[:, 2] * inv_w

    # Each index by a Python list (nxt, prv) copies the list to the card,
    # and the copy waits for the stream: 19 host syncs in all.
    count("host_sync.setup_index", 4)
    ax = x[:, nxt]
    ay = y[:, nxt]
    dx = x[:, prv] - ax
    dy = y[:, prv] - ay
    area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (y[:, 1] - y[:, 0]) * (
        x[:, 2] - x[:, 0]
    )
    sgn = torch.where(area < 0, -1.0, 1.0)
    area_abs = area.abs()
    valid = front & (area_abs > 0)
    inv_area = torch.where(valid, 1.0 / torch.clamp(area_abs, min=1e-30), 0.0)
    dxs = dx * sgn[:, None]
    dys = dy * sgn[:, None]

    alpha = -dys  # (B, 3, T)
    beta = dxs
    gamma = dys * ax - dxs * ay
    # z/w plane: z_c = sum_i zw_i * inv_area * edge_plane_i_c.
    zc = zw * inv_area[:, None]
    if z_dot:
        z_a, z_b, z_g = (fma_dot3(zc, c, 1) for c in (alpha, beta, gamma))
    else:
        z_a = zc[:, 0] * alpha[:, 0] + zc[:, 1] * alpha[:, 1] + zc[:, 2] * alpha[:, 2]
        z_b = zc[:, 0] * beta[:, 0] + zc[:, 1] * beta[:, 1] + zc[:, 2] * beta[:, 2]
        z_g = zc[:, 0] * gamma[:, 0] + zc[:, 1] * gamma[:, 1] + zc[:, 2] * gamma[:, 2]
    bbox4 = torch.stack(
        [x.amin(dim=1), x.amax(dim=1), y.amin(dim=1), y.amax(dim=1)], dim=1
    )

    # Clipless homogeneous planes for near-plane-crossing triangles, built
    # from clip coordinates without dividing by w.
    hx = (v4[:, 0] + v4[:, 3]) * (width * 0.5)  # x_pixel * w  (B, 3, T)
    hy = (v4[:, 1] + v4[:, 3]) * (height * 0.5)
    count("host_sync.setup_index", 12)
    ha = hy[:, nxt] * w[:, prv] - w[:, nxt] * hy[:, prv]  # cofactor rows
    hb = w[:, nxt] * hx[:, prv] - hx[:, nxt] * w[:, prv]
    hg = hx[:, nxt] * hy[:, prv] - hy[:, nxt] * hx[:, prv]
    det = ha[:, 0] * hx[:, 0] + hb[:, 0] * hy[:, 0] + hg[:, 0] * w[:, 0]
    hsgn = torch.where(det < 0, -1.0, 1.0)
    det_abs = det.abs()
    inv_det = torch.where(det_abs > 0, 1.0 / torch.clamp(det_abs, min=1e-30), 0.0)
    zq = v4[:, 2] * (hsgn * inv_det)[:, None]
    hz_a = ha[:, 0] * zq[:, 0] + ha[:, 1] * zq[:, 1] + ha[:, 2] * zq[:, 2]
    hz_b = hb[:, 0] * zq[:, 0] + hb[:, 1] * zq[:, 1] + hb[:, 2] * zq[:, 2]
    hz_g = hg[:, 0] * zq[:, 0] + hg[:, 1] * zq[:, 1] + hg[:, 2] * zq[:, 2]
    # Common positive per-triangle rescale keeps cofactors ~1 (cancels in
    # every edge ratio; the depth plane above is not rescaled).
    m = torch.maximum(
        ha.abs().amax(dim=1),
        torch.maximum(hb.abs().amax(dim=1), hg.abs().amax(dim=1)),
    )
    hsc = (torch.where(m > 0, 1.0 / torch.clamp(m, min=1e-30), 0.0) * hsgn)[:, None]
    ha, hb, hg = ha * hsc, hb * hsc, hg * hsc

    cr = crossing[:, None]
    alpha = torch.where(cr, ha, alpha)
    beta = torch.where(cr, hb, beta)
    gamma = torch.where(cr, hg, gamma)
    z_a = torch.where(crossing, hz_a, z_a)
    z_b = torch.where(crossing, hz_b, z_b)
    z_g = torch.where(crossing, hz_g, z_g)
    # inv_w = inv_area = 1 makes the attribute planes the homogeneous
    # barycentrics e_i / sum_j e_j.
    inv_w = torch.where(cr, 1.0, inv_w)
    inv_area = torch.where(crossing, 1.0, inv_area)
    valid = valid | (crossing & (det_abs > 0))
    if backface_cull:
        # Pre-normalization area sign; crossing triangles are exempt.
        valid = valid & ~(front & (area * backface_cull < 0))

    # Conservative bbox for crossing triangles: project the candidate
    # points of the w >= eps_b clipped polygon.
    eps_b = torch.clamp(1e-4 * w.abs().amax(dim=1), min=1e-7)[:, None]
    v_ok = w > eps_b
    count("host_sync.setup_index", 3)
    wj = w[:, nxt]
    cross_e = (w > eps_b) != (wj > eps_b)
    dw = wj - w
    tt = (eps_b - w) / torch.where(dw.abs() < 1e-30, 1e-30, dw)
    xc = v4[:, 0] + tt * (v4[:, 0][:, nxt] - v4[:, 0])
    yc = v4[:, 1] + tt * (v4[:, 1][:, nxt] - v4[:, 1])
    pxc = (xc / eps_b + 1.0) * (width * 0.5)
    pyc = (yc / eps_b + 1.0) * (height * 0.5)

    def _mm(vals, ok, take_min):
        big = 3e9
        if take_min:
            return torch.where(ok, vals, big).amin(dim=1)
        return torch.where(ok, vals, -big).amax(dim=1)

    bbox_cross = torch.stack(
        [
            torch.minimum(_mm(x, v_ok, True), _mm(pxc, cross_e, True)),
            torch.maximum(_mm(x, v_ok, False), _mm(pxc, cross_e, False)),
            torch.minimum(_mm(y, v_ok, True), _mm(pyc, cross_e, True)),
            torch.maximum(_mm(y, v_ok, False), _mm(pyc, cross_e, False)),
        ],
        dim=1,
    )
    bbox4 = torch.where(cr, bbox_cross, bbox4)

    planes12 = torch.stack(
        [
            alpha[:, 0], beta[:, 0], gamma[:, 0],
            alpha[:, 1], beta[:, 1], gamma[:, 1],
            alpha[:, 2], beta[:, 2], gamma[:, 2],
            z_a, z_b, z_g,
        ],
        dim=1,
    )
    return _TriSetupT(
        planes12=_pad_last(planes12),
        inv_w=_pad_last(inv_w),
        inv_area=_pad_last(inv_area),
        valid=_pad_last(valid, False),
        bbox4=_pad_last(bbox4),
    )


def _bbox_vectors(setup: _TriSetupT):
    """(xmin, xmax, ymin, ymax), each (B, T), of the live triangle slots."""
    b = setup.bbox4[:, :, :-1]
    return b[:, 0], b[:, 1], b[:, 2], b[:, 3]


def _bin_classify(
    setup: _TriSetupT,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    span_y_max: int,
    span_x_max: int,
    n_med: int,
    med_span_y: int,
    med_span_x: int,
    tiny_px: float = 0.0,
):
    """bbox -> tile range and size tier, shared by :func:`_bin_flat` and
    :func:`binning_stats` so the budget guard stays in lockstep with the
    binning. Returns (tx0, tx1, ty0, ty1, span_x, span_y, on_screen, small,
    medium, huge), each (B, T); ``small`` is masked by on_screen,
    ``medium``/``huge`` are not. ``tiny_px`` > 0 takes the triangles of
    :func:`_tiny_mask` out of the small tier: the sort path owns them."""
    n_ty = -(-height // tile_h)
    n_tx = -(-width // tile_w)
    xmin, xmax, ymin, ymax = _bbox_vectors(setup)

    def tile_index(v, size, n):
        # clamp keeps NaN, and the saturating cast sends it to 0 as XLA does
        return to_int32_sat(torch.clamp(torch.floor(v / size), 0, n - 1))

    tx0 = tile_index(xmin - 0.5, tile_w, n_tx)
    tx1 = tile_index(xmax + 0.5, tile_w, n_tx)
    ty0 = tile_index(ymin - 0.5, tile_h, n_ty)
    ty1 = tile_index(ymax + 0.5, tile_h, n_ty)
    on_screen = (
        (xmax >= 0) & (xmin <= width) & (ymax >= 0) & (ymin <= height)
        & setup.valid[:, :-1]
    )
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    big = (span_x > span_x_max) | (span_y > span_y_max)
    if n_med > 0:
        fits_med = (span_x <= med_span_x) & (span_y <= med_span_y)
        medium = big & fits_med
        huge = big & ~fits_med
    else:
        medium = torch.zeros_like(big)
        huge = big
    small = on_screen & ~big
    if tiny_px > 0:
        # A tiny bbox spans one tile, so only the small tier loses them.
        small = small & ~_tiny_mask(setup, tiny_px)
    return tx0, tx1, ty0, ty1, span_x, span_y, on_screen, small, medium, huge


def _tiny_mask(setup: _TriSetupT, tiny_px: float) -> torch.Tensor:
    """Live triangles whose bbox is smaller than tiny_px in both axes: at
    most one pixel centre per axis, the sort path's triangles."""
    xmin, xmax, ymin, ymax = _bbox_vectors(setup)
    return (
        setup.valid[:, :-1] & ((xmax - xmin) < tiny_px) & ((ymax - ymin) < tiny_px)
    )


# Relative margin of the dead-entry corner cull (RasterizerConfig.bin_cull);
# the JAX package's _CULL_MARGIN, whose derivation it documents.
_CULL_MARGIN = 2e-5


def _edge_rows9(setup: _TriSetupT):
    """The nine edge-plane rows, each (B, T)."""
    return [setup.planes12[:, k, :-1] for k in range(9)]


def _topk_small(prio: torch.Tensor, g: int):
    """Top ``g`` of each row of (B, T) int32 priorities by g argmax-and-mask
    passes: values descending, first index on ties (``torch.argmax``
    returns the first maximum, as ``jnp.argmax`` does). Returns (values,
    indices), each (B, g)."""
    p = prio.clone()
    neg = torch.iinfo(p.dtype).min
    vals, idx = [], []
    for _ in range(g):
        i = torch.argmax(p, dim=1, keepdim=True)
        vals.append(torch.gather(p, 1, i))
        idx.append(i)
        p.scatter_(1, i, neg)
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


def _top_tier(prio: torch.Tensor, g: int):
    """The g highest priorities per row, as the JAX package selects them."""
    if g <= 64:
        return _topk_small(prio, g)
    vals, idx = torch.topk(prio, g, dim=1)
    return vals, idx


def _bin_flat(
    setup: _TriSetupT,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    span_y_max: int,
    span_x_max: int,
    n_huge: int,
    flat_cap_factor: int = 0,
    n_med: int = 0,
    med_span_y: int = 8,
    med_span_x: int = 4,
    tiny_px: float = 0.0,
    cap_abs: int = 0,
    small_cap: int = 0,
    cull_margin: float = 0.0,
):
    """Flat binning: ONE sort per view of (tile, tri) keys ``tile*T + tri``.

    Returns (s_tri (B, L) i32 — triangle ids tile-major then ascending,
    sentinel T in the tail; s_tile (B, L) i32, n_tiles for sentinels;
    starts (B, n_tiles) i32; counts (B, n_tiles) i32). Each tile's live
    entries are s_tri[starts : starts + counts].

    Three size tiers as in the JAX package: the small span block per
    triangle (direct or two-stage emission), up to ``n_med`` medium
    triangles with a med span block, and up to ``n_huge`` huge ones with
    one key per overlapped tile. ``cull_margin`` > 0 drops (triangle,
    tile) keys whose triangle provably covers no pixel centre of the tile.
    Overflowing budgets drop triangles; :func:`binning_stats` guards them."""
    n_ty = -(-height // tile_h)
    n_tx = -(-width // tile_w)
    n_tiles = n_ty * n_tx
    bsz = setup.valid.shape[0]
    t_total = setup.valid.shape[1] - 1
    dev = setup.valid.device

    (tx0, tx1, ty0, ty1, span_x, span_y, on_screen, small, medium, huge) = (
        _bin_classify(
            setup, width, height, tile_h, tile_w, span_y_max, span_x_max,
            n_med, med_span_y, med_span_x, tiny_px=tiny_px,
        )
    )
    tri_idx = torch.arange(t_total, dtype=torch.int32, device=dev).expand(
        bsz, t_total
    )
    sentinel = n_tiles * t_total

    cm = float(cull_margin)
    if cm > 0.0:
        e9 = _edge_rows9(setup)
        xmin, xmax, ymin, ymax = _bbox_vectors(setup)
        # Pixel-centre rect of the triangle's own bbox (centres at +0.5).
        cb = (
            torch.ceil(xmin - 0.5) + 0.5, torch.floor(xmax - 0.5) + 0.5,
            torch.ceil(ymin - 0.5) + 0.5, torch.floor(ymax - 0.5) + 0.5,
        )

    def _dead_at(ty, tx, e9=None, cb=None):
        """True where a (triangle, tile) entry provably covers no pixel
        centre: the rect tile ∩ bbox is empty, or the max of some edge
        function over it is below -margin * magnitude."""
        bx0, bx1, by0, by1 = cb
        txf = tx.to(torch.float32)
        tyf = ty.to(torch.float32)
        rx0 = torch.maximum(txf * tile_w + 0.5, bx0)
        rx1 = torch.minimum(txf * tile_w + (tile_w - 0.5), bx1)
        ry0 = torch.maximum(tyf * tile_h + 0.5, by0)
        ry1 = torch.minimum(tyf * tile_h + (tile_h - 0.5), by1)
        dead = (rx1 < rx0) | (ry1 < ry0)
        rxw = torch.clamp(rx1 - rx0, min=0.0)
        ryh = torch.clamp(ry1 - ry0, min=0.0)
        for k in range(3):
            a, b, g = e9[3 * k], e9[3 * k + 1], e9[3 * k + 2]
            emax = (
                a * rx0 + b * ry0 + g
                + torch.clamp(a * rxw, min=0.0)
                + torch.clamp(b * ryh, min=0.0)
            )
            mag = a.abs() * rx1.abs() + b.abs() * ry1.abs() + g.abs()
            dead = dead | (emax < -(cm * mag))
        return dead

    def _key(tile, tri, valid):
        return torch.where(valid, tile * t_total + tri, sentinel)

    sc = min(small_cap, t_total) if small_cap > 0 else 0
    keys = []
    if 0 < sc < t_total:
        # Two-stage small tier: compact the live small-tier ids with one
        # sort (ids are unique), then emit span keys for the sc-id prefix.
        skey = torch.where(small, tri_idx, t_total)
        sid = torch.sort(skey, dim=1).values[:, :sc]
        slive = sid < t_total
        sid_c = torch.clamp(sid, max=t_total - 1)
        sidx = sid_c.long()
        sty0, stx0 = torch.gather(ty0, 1, sidx), torch.gather(tx0, 1, sidx)
        ssy, ssx = torch.gather(span_y, 1, sidx), torch.gather(span_x, 1, sidx)
        if cm > 0.0:
            # Dead masks on the full (T,) columns, one bit per span slot,
            # gathered with the compacted rows (the same booleans as the
            # direct emission).
            dead_cols = []
            for sy in range(span_y_max):
                for sx in range(span_x_max):
                    dead_cols.append(
                        torch.gather(
                            _dead_at(ty0 + sy, tx0 + sx, e9, cb), 1, sidx
                        )
                    )
        slot = 0
        for sy in range(span_y_max):
            for sx in range(span_x_max):
                tile = torch.clamp(
                    (sty0 + sy) * n_tx + (stx0 + sx), max=n_tiles
                )
                valid = slive & (sx < ssx) & (sy < ssy)
                if cm > 0.0:
                    valid = valid & ~dead_cols[slot]
                slot += 1
                keys.append(_key(tile, sid_c, valid))
    else:
        for sy in range(span_y_max):
            for sx in range(span_x_max):
                # Clamp: masked-out lanes still compute tile * T, and an
                # off-grid tile could overflow the int32 key space.
                tile = torch.clamp((ty0 + sy) * n_tx + (tx0 + sx), max=n_tiles)
                valid = small & (sx < span_x) & (sy < span_y)
                if cm > 0.0:
                    valid = valid & ~_dead_at(ty0 + sy, tx0 + sx, e9, cb)
                keys.append(_key(tile, tri_idx, valid))

    def _rows(cols, idx):
        return [torch.gather(c_, 1, idx) for c_ in cols]

    gm = min(n_med, t_total) if n_med > 0 else 0
    if gm > 0:
        prio_m = torch.where(medium & on_screen, t_total - tri_idx, 0)
        mvals, midx = _top_tier(prio_m, gm)
        midx = torch.clamp(midx, 0, t_total - 1)
        mid = midx.to(torch.int32)  # (B, Gm)
        mvalid = mvals > 0
        mty0, mtx0, msy, msx = _rows([ty0, tx0, span_y, span_x], midx)
        if cm > 0.0:
            mcb = tuple(_rows(cb, midx))
            me9 = _rows(e9, midx)
        for sy in range(med_span_y):
            for sx in range(med_span_x):
                tile = torch.clamp(
                    (mty0 + sy) * n_tx + (mtx0 + sx), max=n_tiles
                )
                valid = mvalid & (sy < msy) & (sx < msx)
                if cm > 0.0:
                    valid = valid & ~_dead_at(mty0 + sy, mtx0 + sx, me9, mcb)
                keys.append(_key(tile, mid, valid))

    g = min(n_huge, t_total) if n_huge > 0 else 0
    if g > 0:
        prio = torch.where(huge & on_screen, t_total - tri_idx, 0)
        top_vals, hidx = _top_tier(prio, g)
        hidx = torch.clamp(hidx, 0, t_total - 1)
        hid = hidx.to(torch.int32)  # (B, G)
        hvalid = top_vals > 0
        tiles = torch.arange(n_tiles, dtype=torch.int32, device=dev)
        tyi = tiles // n_tx
        txi = tiles % n_tx
        hx0, hx1, hy0, hy1 = (
            r[..., None] for r in _rows([tx0, tx1, ty0, ty1], hidx)
        )
        hov = (
            hvalid[..., None]
            & (txi >= hx0) & (txi <= hx1) & (tyi >= hy0) & (tyi <= hy1)
        )  # (B, G, n_tiles)
        if cm > 0.0:
            hcb = tuple(r[..., None] for r in _rows(cb, hidx))
            he9 = [r[..., None] for r in _rows(e9, hidx)]
            hov = hov & ~_dead_at(tyi, txi, he9, hcb)
        keys.append(_key(tiles, hid[..., None], hov).reshape(bsz, -1))

    # Keys are unique except the interchangeable sentinels, so an unstable
    # sort gives the same list as the reference's.
    keys = torch.sort(torch.cat(keys, dim=1), dim=1).values
    cap = keys.shape[1]
    if flat_cap_factor > 0:
        cap = min(cap, flat_cap_factor * t_total)
    if cap_abs > 0:
        cap = min(cap, cap_abs)
    keys = keys[:, :cap]
    s_tile = torch.div(keys, t_total, rounding_mode="floor")
    s_tri = torch.remainder(keys, t_total)
    s_tri = torch.where(s_tile < n_tiles, s_tri, t_total)

    # Segment starts/counts: binary search on the sorted tile ids (left
    # side, as the reference's searchsorted(side="left")).
    tile_ids = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev)
    bounds = torch.searchsorted(
        s_tile, tile_ids.expand(bsz, n_tiles + 1).contiguous(), out_int32=True
    )
    starts = bounds[:, :-1]
    counts = bounds[:, 1:] - bounds[:, :-1]
    return s_tri, s_tile, starts, counts


def _read_max(x: torch.Tensor) -> int:
    """The largest value of ``x``, read on the host."""
    count("host_sync.binning_stats")
    return int(x.max())


def binning_stats(pos, tri, resolution, config: RasterizerConfig = DEFAULT_CONFIG):
    """Exact per-scene binning-budget diagnostics: the worst view's tier
    counts, live entries and per-tile maximum beside their configured
    budgets. ``ok`` is True iff every budget holds, i.e. the flat binning
    is lossless for this scene and config. pos (B, V, 4) clip positions."""
    _check_ported(config)
    height, width = resolution
    tile_h, tile_w = config.tile_h, config.tile_w
    full_ty = -(-height // tile_h)
    n_tx = -(-width // tile_w)
    t_total = int(tri.shape[0])
    # bin_subtile: classify and count at the band grid K1's binning uses,
    # (tile_h / s)-row bins over the padded tile grid.
    sub = max(config.bin_subtile, 1)
    bin_h = tile_h // sub
    bin_height = full_ty * tile_h if sub > 1 else height
    n_ty = full_ty * sub
    k_cap = config.max_tris_per_tile or _auto_cap(t_total, n_ty * n_tx)

    pos = pos.to(torch.float32)
    setup = _triangle_setup_t(
        _clip_corners(pos, tri), width, height, config.backface_cull
    )
    (tx0, tx1, ty0, ty1, span_x, span_y, on, small, medium, huge) = (
        _bin_classify(
            setup, width, bin_height, bin_h, tile_w,
            config.bin_span_tiles_y, config.bin_span_tiles_x,
            config.bin_med, config.bin_med_span_y, config.bin_med_span_x,
            tiny_px=config.bin_tiny_px,
        )
    )
    bsz = pos.shape[0]
    n_small = small.sum(dim=1)
    # Potential sort-path triangles at the 1 px exactness bound, whatever
    # the config (auto_fast_config decides from it whether the path pays).
    n_tiny = _tiny_mask(setup, 1.0).sum(dim=1)
    n_tiny_cov = torch.zeros(bsz, dtype=torch.int64, device=pos.device)
    if config.bin_tiny_px > 0:
        # Tiny triangles make no binning entries; the covered candidates
        # are counted with the sort path's own candidate test, so the
        # bin_tiny_cap guard counts exactly what the path emits.
        from .gbuffer import _tiny_candidates

        tiny_on = _tiny_mask(setup, config.bin_tiny_px)
        on = on & ~tiny_on
        pix, _ = _tiny_candidates(setup.planes12, setup.bbox4, tiny_on,
                                  height, width, tile_h, tile_w)
        n_tiny_cov = (pix < height * width).sum(dim=1)
    n_med = (medium & on).sum(dim=1)
    n_huge = (huge & on).sum(dim=1)
    live = torch.where(on, span_x * span_y, 0).sum(dim=1)
    # Exact per-tile counts via a 2D difference grid and prefix sums.
    grid = torch.zeros((bsz, n_ty + 1, n_tx + 1), dtype=torch.int32,
                       device=pos.device)
    one = on.to(torch.int32)
    bidx = torch.arange(bsz, device=pos.device)[:, None].expand_as(tx0)
    for gy, gx, sign in ((ty0, tx0, 1), (ty0, tx1 + 1, -1),
                         (ty1 + 1, tx0, -1), (ty1 + 1, tx1 + 1, 1)):
        grid.index_put_(
            (bidx.reshape(-1), gy.reshape(-1).long(), gx.reshape(-1).long()),
            (sign * one).reshape(-1), accumulate=True,
        )
    counts = grid.cumsum(dim=1).cumsum(dim=2)[:, :n_ty, :n_tx]
    max_tile = counts.reshape(bsz, -1).amax(dim=1)

    flat_cap = (
        config.bin_flat_cap_factor * t_total
        if config.bin_flat_cap_factor > 0 else 2**62
    )
    if config.bin_flat_cap_abs > 0:
        flat_cap = min(flat_cap, config.bin_flat_cap_abs)
    stats = {
        "n_huge": _read_max(n_huge),
        "huge_budget": int(config.bin_huge),
        "n_med": _read_max(n_med),
        "med_budget": int(config.bin_med),
        "live_entries": _read_max(live),
        "flat_cap": int(min(flat_cap, 2**62)),
        "max_per_tile": _read_max(max_tile),
        "k_cap": int(k_cap),
        "n_tiny_1px": _read_max(n_tiny),
        "n_small_tris": _read_max(n_small),
        "small_cap_budget": int(config.bin_small_cap),
        "n_tiny_cov": _read_max(n_tiny_cov),
        "tiny_cap_budget": int(config.bin_tiny_cap),
    }
    small_cap_on = 0 < config.bin_small_cap < t_total
    tiny_cap_on = config.bin_tiny_px > 0 and 0 < config.bin_tiny_cap < t_total
    stats["ok"] = (
        stats["n_huge"] <= stats["huge_budget"]
        and stats["n_med"] <= stats["med_budget"]
        and stats["live_entries"] <= stats["flat_cap"]
        and stats["max_per_tile"] <= stats["k_cap"]
        and (
            not small_cap_on
            or stats["n_small_tris"] <= stats["small_cap_budget"]
        )
        and (
            not tiny_cap_on
            or stats["n_tiny_cov"] <= stats["tiny_cap_budget"]
        )
    )
    return stats


def auto_fast_config(
    pos,
    tri,
    resolution,
    base: RasterizerConfig = FAST_TPU_CONFIG,
    headroom: float = 2.0,
    cap_headroom: float = 1.5,
    extra_probes=(),
    auto_tiny: bool = True,
    backface_cull: int = 0,
) -> RasterizerConfig:
    """Scene-adaptive binning budgets for the fast path, sized from this
    scene's :func:`binning_stats` times ``headroom`` (rounded up to powers
    of two) and validated lossless. pos (B, V, 4) clip positions for the
    cameras that will be rendered; ``extra_probes`` are further
    (pos, tri, resolution) the same config must stay lossless for. With
    ``bin_tiny_px`` on (set by the caller, or by ``auto_tiny`` for scenes of
    at least 300k triangles, 60% of them sub-pixel), the absolute entry
    cap, the small-tier cap and the sort path's candidate cap are sized
    from the measured counts times ``cap_headroom``. Returns the same
    config as the JAX package's ``auto_fast_config``."""
    if backface_cull:
        base = base._replace(backface_cull=backface_cull)
    if auto_tiny and base.bin_tiny_px == 0:
        # Heavily sub-pixel scenes (at least 300k triangles, 60% of them
        # under a pixel) switch to the sort path.
        t_total = int(tri.shape[0])
        if t_total >= 300_000:
            pre = binning_stats(pos, tri, resolution, base)
            if pre["n_tiny_1px"] >= 0.6 * t_total:
                base = base._replace(bin_tiny_px=1.0)
    probe = base._replace(bin_med=max(base.bin_med, 1))
    probes = [(pos, tri, resolution)] + list(extra_probes)
    stats_list = [binning_stats(p, t, r, probe) for p, t, r in probes]
    stats = {
        k: max(st[k] for st in stats_list)
        for k in ("n_med", "n_huge", "max_per_tile", "live_entries")
    }

    def pow2_at_least(n, lo):
        v = lo
        while v < n:
            v *= 2
        return v

    n_med = stats["n_med"]
    n_huge = stats["n_huge"]
    med = 0 if n_med == 0 else pow2_at_least(int(headroom * n_med), 64)
    huge = pow2_at_least(int(headroom * n_huge) + 8, 16)
    k_cap = base.max_tris_per_tile
    if k_cap is not None and stats["max_per_tile"] > k_cap:
        k_cap = pow2_at_least(int(headroom * stats["max_per_tile"]), k_cap)
    cap_factor = base.bin_flat_cap_factor
    if cap_factor > 0:
        for (_, t_i, _), st in zip(probes, stats_list):
            t_tot = int(t_i.shape[0])
            if st["live_entries"] > cap_factor * t_tot:
                cap_factor = max(
                    cap_factor,
                    -(-int(headroom * st["live_entries"]) // t_tot),
                )

    def granule(need):
        # Powers of two up to 64k entries, then multiples of 8,192.
        return (pow2_at_least(need, 4096) if need <= 65536
                else -(-need // 8192) * 8192)

    cap_abs = base.bin_flat_cap_abs
    small_cap = base.bin_small_cap
    tiny_cap = base.bin_tiny_cap
    if base.bin_tiny_px > 0:
        # With the sort path on, the binned entries, the small tier and the
        # covered sort-path candidates sit far below their T-sized bounds:
        # size an absolute entry cap, a two-stage small tier and the
        # candidate compaction from the worst view, times cap_headroom.
        worst = {k: max(st[k] for st in stats_list)
                 for k in ("live_entries", "n_small_tris", "n_tiny_cov")}
        cap_abs = granule(int(cap_headroom * worst["live_entries"]))
        small_cap = granule(int(cap_headroom * worst["n_small_tris"]))
        tiny_cap = granule(int(cap_headroom * worst["n_tiny_cov"]))
    cfg = base._replace(
        bin_med=med, bin_huge=huge, max_tris_per_tile=k_cap,
        bin_flat_cap_factor=cap_factor, bin_flat_cap_abs=cap_abs,
        bin_small_cap=small_cap, bin_tiny_cap=tiny_cap,
    )
    for p_i, t_i, r_i in probes:
        final = binning_stats(p_i, t_i, r_i, cfg)
        if not final["ok"]:
            raise ValueError(f"auto_fast_config failed to validate: {final}")
    return cfg


# ---- The classic per-view layout and the per-tile path ----------------------

class _TriSetup(NamedTuple):
    """Per-triangle screen-space planes in the classic layout, views
    leading, with a trailing padded slot T (valid=False) that binned id
    lists pad with: edge i of triangle t is ``planes[:, t, i, 0] * px +
    planes[:, t, i, 1] * py + planes[:, t, i, 2]``; row 3 is the z plane."""

    planes: torch.Tensor  # (B, T+1, 4, 3) f32
    inv_w: torch.Tensor  # (B, T+1, 3)
    inv_area: torch.Tensor  # (B, T+1)
    valid: torch.Tensor  # (B, T+1) bool
    bbox: torch.Tensor  # (B, T+1, 4) xmin, xmax, ymin, ymax


def _triangle_setup(
    pos_clip: torch.Tensor,
    tri: torch.Tensor,
    width: int,
    height: int,
    backface_cull: int = 0,
) -> _TriSetup:
    """The JAX package's classic ``_triangle_setup`` for every view:
    pos_clip (B, V, 4), tri (T, 3). The same planes as
    :func:`_triangle_setup_t` but for the z plane, which the classic setup
    contracts with an fp32 ``einsum``."""
    return _classic_layout(_triangle_setup_t(
        _clip_corners(pos_clip, tri), width, height, backface_cull, z_dot=True
    ))


def _classic_layout(st: _TriSetupT) -> _TriSetup:
    """A ``_TriSetupT`` in the classic layout, views leading."""
    bsz, _, t1 = st.planes12.shape
    return _TriSetup(
        planes=st.planes12.transpose(1, 2).reshape(bsz, t1, 4, 3).contiguous(),
        inv_w=st.inv_w.transpose(1, 2).contiguous(),
        inv_area=st.inv_area,
        valid=st.valid,
        bbox=st.bbox4.transpose(1, 2).contiguous(),
    )


def _bin_triangles(
    setup: _TriSetup,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    max_per_tile: int,
):
    """Dense per-tile binning: the overlapping triangles of each tile in
    input order, by a stable argsort of the (tile, triangle) overlap.
    Returns (ids (B, n_tiles, K) i32 padded with T, counts (B, n_tiles) i32
    of live entries, a prefix of each list), K = min(max_per_tile, T).

    This is the branch of the JAX package's ``_bin_dispatch`` that its
    callers reach: they take the flat path wherever its sort_pairs branch
    would apply."""
    n_ty = -(-height // tile_h)
    n_tx = -(-width // tile_w)
    t_total = setup.valid.shape[1] - 1
    dev = setup.valid.device
    bbox = setup.bbox[:, :-1]

    def tile_index(v, size, n):
        return to_int32_sat(torch.clamp(torch.floor(v / size), 0, n - 1))

    tx0 = tile_index(bbox[..., 0] - 0.5, tile_w, n_tx)[:, None]  # (B, 1, T)
    tx1 = tile_index(bbox[..., 1] + 0.5, tile_w, n_tx)[:, None]
    ty0 = tile_index(bbox[..., 2] - 0.5, tile_h, n_ty)[:, None]
    ty1 = tile_index(bbox[..., 3] + 0.5, tile_h, n_ty)[:, None]
    on_screen = (
        (bbox[..., 1] >= 0) & (bbox[..., 0] <= width)
        & (bbox[..., 3] >= 0) & (bbox[..., 2] <= height)
        & setup.valid[:, :-1]
    )[:, None]
    tile_ix = torch.arange(n_ty * n_tx, dtype=torch.int32, device=dev)
    tyi = (tile_ix // n_tx)[None, :, None]
    txi = (tile_ix % n_tx)[None, :, None]
    overlap = (
        (txi >= tx0) & (txi <= tx1) & (tyi >= ty0) & (tyi <= ty1) & on_screen
    )  # (B, n_tiles, T)
    k = min(max_per_tile, t_total)
    order = torch.argsort((~overlap).to(torch.uint8), dim=2, stable=True)
    counts = overlap.sum(dim=2, dtype=torch.int32)
    keep = torch.arange(k, device=dev) < counts[..., None]
    ids = torch.where(keep, order[..., :k].to(torch.int32), t_total)
    return ids, torch.clamp(counts, max=k)


def _tile_origins(n_ty: int, n_tx: int, tile_h: int, tile_w: int, dev):
    """(n_tiles, 2) f32 pixel origins (x0, y0) of the tiles, row-major."""
    tile_ix = torch.arange(n_ty * n_tx, dtype=torch.int32, device=dev)
    return torch.stack(
        [(tile_ix % n_tx * tile_w).to(torch.float32),
         (tile_ix // n_tx * tile_h).to(torch.float32)],
        dim=-1,
    )


def _rebase_rows(planes, valid, origin):
    """Rebase gathered (..., K, R, 3) plane rows to their tiles' origins
    (g + a*ox + b*oy) and give invalid entries an e0 constant of
    ``BIG_NEG``; ``origin`` (n_tiles, 2) matches the tile dim at -4."""
    ox = origin[:, 0, None, None]
    oy = origin[:, 1, None, None]
    gamma = planes[..., 2] + planes[..., 0] * ox + planes[..., 1] * oy
    gamma = torch.cat(
        [torch.where(valid[..., None], gamma[..., :1], BIG_NEG), gamma[..., 1:]],
        dim=-1,
    )
    return torch.cat([planes[..., :2], gamma[..., None]], dim=-1)


def _gather_tile_rows(all_planes, valid, ids, tile_origin):
    """Each tile's plane rows, rebased to the tile origin: all_planes
    (B, T+1, R, 3), valid (B, T+1), ids (B, n_tiles, K) -> (B * n_tiles,
    3, R*K) coef-major, R blocks of K. Invalid and padded entries get an e0
    constant of ``BIG_NEG`` (never covered)."""
    bsz, n_tiles, _ = ids.shape
    bidx = torch.arange(bsz, device=ids.device)[:, None, None]
    idx = ids.long()
    planes = _rebase_rows(all_planes[bidx, idx], valid[bidx, idx], tile_origin)
    return planes.permute(0, 1, 4, 3, 2).reshape(bsz * n_tiles, 3, -1)


def _gather_tile_rows_flat(all_planes, valid, flat, k_cap, n_tx, tile_w,
                           tile_h):
    """The tile rows of :func:`_gather_tile_rows` from a flat binning
    (:func:`_bin_flat`), as the JAX package's ``_gather_tile_rows_flat``
    builds them: every sorted entry's planes rebased to its own tile's
    origin, then each tile's window of ``k_cap`` entries from its start.
    Entries of a window past the tile's count (the next tiles' entries, or
    padding) get an e0 constant of ``BIG_NEG``. all_planes (B, T+1, R, 3),
    valid (B, T+1). Returns (coeffs (B * n_tiles, 3, R*k_cap), counts
    (B * n_tiles,) i32, each at most k_cap)."""
    s_tri, s_tile, starts, counts = flat
    bsz, n_tiles = starts.shape
    r = all_planes.shape[2]
    dev = all_planes.device
    bidx = torch.arange(bsz, device=dev)[:, None]
    tri = s_tri.long()
    ep = all_planes[bidx, tri]  # (B, L, R, 3)
    live = valid[bidx, tri] & (s_tile < n_tiles)
    st = torch.clamp(s_tile, 0, n_tiles - 1)
    ox = ((st % n_tx) * tile_w).to(torch.float32)[..., None]
    oy = ((st // n_tx) * tile_h).to(torch.float32)[..., None]
    gamma = ep[..., 2] + ep[..., 0] * ox + ep[..., 1] * oy  # (B, L, R)
    gamma = torch.cat(
        [torch.where(live[..., None], gamma[..., :1], BIG_NEG), gamma[..., 1:]],
        dim=-1,
    )
    ep = torch.stack([ep[..., 0], ep[..., 1], gamma], dim=-1)
    # k_cap never-covering entries after the list, so no window is cut.
    pad = edge0_pad_block(r, k_cap, torch.float32, BIG_NEG, dev).permute(2, 1, 0)
    ep = torch.cat([ep, pad.expand(bsz, k_cap, r, 3)], dim=1)
    j = torch.arange(k_cap, device=dev)
    win = ep[bidx[..., None], starts.long()[..., None] + j]  # (B, n_tiles, K, R, 3)
    used = torch.clamp(counts, max=k_cap)
    e0g = torch.where(j < used[..., None], win[..., 0, 2], BIG_NEG)
    win = torch.cat(
        [torch.cat([win[..., :1, :2], e0g[..., None, None]], dim=-1),
         win[..., 1:, :]],
        dim=-2,
    )
    coeffs = win.permute(0, 1, 4, 3, 2).reshape(bsz * n_tiles, 3, r * k_cap)
    return coeffs, used.reshape(-1)


def _gather_tile_coeffs(
    setup: _TriSetup, ids: torch.Tensor, tile_origin: torch.Tensor
) -> torch.Tensor:
    """K4's input: each tile's [e0|e1|e2|z] blocks of K, (B * n_tiles, 3,
    4K)."""
    return _gather_tile_rows(setup.planes, setup.valid, ids, tile_origin)


def _detile(x: torch.Tensor, bsz, n_ty, n_tx, height, width):
    """(B * n_tiles, th, tw) tiles -> (B, height, width), and
    (B * n_tiles, C, th, tw) -> (B, C, height, width)."""
    th, tw = x.shape[-2:]
    chans = tuple(x.shape[1:-2])
    x = x.reshape(bsz, n_ty, n_tx, -1, th, tw).permute(0, 3, 1, 4, 2, 5)
    x = x.reshape(bsz, -1, n_ty * th, n_tx * tw)[:, :, :height, :width]
    return x.reshape((bsz,) + chans + (height, width))


def _pixel_centres(bsz, height, width, dev):
    px = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    return (px[None, None, :].expand(bsz, height, width),
            py[None, :, None].expand(bsz, height, width))


def _winner_rows(setup: _TriSetup, idmap: torch.Tensor):
    """(planes (B, H, W, 4, 3), inv_w (B, H, W, 3), inv_area (B, H, W)) of
    each pixel's triangle (triangle 0 on background)."""
    t = torch.clamp(idmap - 1, min=0).long()
    bidx = torch.arange(idmap.shape[0], device=idmap.device)[:, None, None]
    return setup.planes[bidx, t], setup.inv_w[bidx, t], setup.inv_area[bidx, t]


def _resolve_uv(setup: _TriSetup, idmap: torch.Tensor,
                zmap: torch.Tensor) -> torch.Tensor:
    """Perspective-correct (u, v) of each pixel's winning triangle: idmap
    (B, H, W) i32 (0 = background), zmap (B, H, W). Returns rast
    (B, H, W, 4) = (u, v, z, idmap)."""
    bsz, h, w = idmap.shape
    px, py = _pixel_centres(bsz, h, w, idmap.device)
    planes, inv_w, inv_area = _winner_rows(setup, idmap)
    e = (planes[..., :3, 0] * px[..., None] + planes[..., :3, 1] * py[..., None]
         + planes[..., :3, 2])  # (B, H, W, 3)
    pw = e * inv_area[..., None] * inv_w
    denom = pw[..., 0] + pw[..., 1] + pw[..., 2]
    denom = torch.where(denom.abs() < 1e-20, 1e-20, denom)
    mask = idmap > 0
    u = torch.where(mask, pw[..., 1] / denom, 0.0)
    v = torch.where(mask, pw[..., 2] / denom, 0.0)
    zout = torch.where(mask, zmap, 0.0)
    return torch.stack([u, v, zout, idmap.to(torch.float32)], dim=-1)


def _resolve_db(setup: _TriSetup, idmap: torch.Tensor) -> torch.Tensor:
    """Analytic image-space derivatives of the winning triangle's
    barycentrics (nvdiffrast's rast_db: du/dX, du/dY, dv/dX, dv/dY), zero on
    background. With u = n1/D, v = n2/D, n_i = e_i * inv_w_i and D = sum
    n_i all screen-affine planes, the quotient rule gives them exactly."""
    bsz, h, w = idmap.shape
    px, py = _pixel_centres(bsz, h, w, idmap.device)
    planes, inv_w, _ = _winner_rows(setup, idmap)
    nc = planes[..., :3, :] * inv_w[..., None]  # (B, H, W, 3 edges, 3 coefs)
    dc = nc[..., 0, :] + nc[..., 1, :] + nc[..., 2, :]  # denominator plane
    n_val = nc[..., 0] * px[..., None] + nc[..., 1] * py[..., None] + nc[..., 2]
    d_val = n_val[..., 0] + n_val[..., 1] + n_val[..., 2]
    d_val = torch.where(d_val.abs() < 1e-20, 1e-20, d_val)
    inv_d2 = 1.0 / (d_val * d_val)

    def ddir(i, c):  # d(n_i / D) / d{X, Y}: (n_i_c * D - n_i * D_c) / D^2
        return (nc[..., i, c] * d_val - n_val[..., i] * dc[..., c]) * inv_d2

    db = torch.stack([ddir(1, 0), ddir(1, 1), ddir(2, 0), ddir(2, 1)], dim=-1)
    return torch.where((idmap > 0)[..., None], db, 0.0)


def _use_flat(config: RasterizerConfig, t_total: int, n_bins: int) -> bool:
    """The flat binned path: sort_pairs binning at scale, int32 keys
    ``bin * T + tri`` over ``n_bins`` bins (the tiles, or on the K1 route
    the tiles times ``bin_subtile``)."""
    return (
        config.bin_mode == "sort_pairs"
        and t_total >= config.bin_sort_pairs_min_tris
        and (n_bins + 1) * t_total < 2**31
    )


def _zid_inputs(pos, tri, height, width, config):
    """Classic setup, dense binning and the tile coefficient gather for a
    batch of views: (setup, K4's inputs ``(coeffs, ids, counts)``, its
    static arguments ``(tile_h, tile_w, chunk)``)."""
    tile_h, tile_w = config.tile_h, config.tile_w
    n_ty, n_tx = -(-height // tile_h), -(-width // tile_w)
    with annotate("wr::raster.setup"):
        setup = _triangle_setup(pos, tri, width, height, config.backface_cull)
    max_per_tile = (config.max_tris_per_tile
                    or _auto_cap(tri.shape[0], n_ty * n_tx))
    with annotate("wr::raster.bin"):
        ids, counts = _bin_triangles(setup, width, height, tile_h, tile_w,
                                     max_per_tile)
    with annotate("wr::raster.chunks"):
        origins = _tile_origins(n_ty, n_tx, tile_h, tile_w, pos.device)
        coeffs = _gather_tile_coeffs(setup, ids, origins)
    inputs = (coeffs, ids.reshape(-1, ids.shape[-1]), counts.reshape(-1))
    return setup, inputs, (tile_h, tile_w, config.chunk)


def _rasterize_tiles(pos, tri, height, width, config):
    """The per-tile path of classic ``rasterize`` for a batch of views: the
    tile coefficients of :func:`_zid_inputs`, ONE K4 launch over every
    (view, tile), then the (u, v) resolve. Returns rast (B, H, W, 4)."""
    n_ty = -(-height // config.tile_h)
    n_tx = -(-width // config.tile_w)
    bsz = pos.shape[0]
    setup, inputs, dims = _zid_inputs(pos, tri, height, width, config)
    z_t, id_t = raster_zid_tiles(*inputs, *dims)
    with annotate("wr::raster.resolve"):
        zmap = _detile(z_t, bsz, n_ty, n_tx, height, width)
        idmap = _detile(id_t, bsz, n_ty, n_tx, height, width)
        return _resolve_uv(setup, idmap, zmap)


def _rasterize_batched(pos, tri, height, width, config):
    n_tiles = (-(-height // config.tile_h)) * (-(-width // config.tile_w))
    if _use_flat(config, tri.shape[0], n_tiles):
        # The flat path emits the whole rast contract: (u, v) are the
        # interpolated one-hot corner attributes of uv mode.
        from .gbuffer import _gbuffer_dma_batched, _gbuffer_single

        # K1 bins at bin_subtile bands: its key space counts them.
        n_bins = n_tiles * max(config.bin_subtile, 1)
        if (config.backend not in _XLA_BACKENDS
                and _use_flat(config, tri.shape[0], n_bins)):
            gbuffer = _gbuffer_dma_batched
        else:
            gbuffer = _gbuffer_single
        _, z, tri_id, uv = gbuffer(
            pos, tri, None, height, width, config, uv_mode=True
        )
        with annotate("wr::raster.resolve"):
            return torch.cat(
                [uv, z[..., None], tri_id.to(torch.float32)[..., None]], dim=-1
            )
    return _rasterize_tiles(pos, tri, height, width, config)


def _classic_inputs(pos, tri, config, device):
    if pos.ndim != 3:
        raise ValueError("pos must be (B, V, 4) — range mode is not supported")
    _check_ported(config)
    dev = resolve_device(device)
    return (pos.to(device=dev, dtype=torch.float32),
            tri.to(device=dev, dtype=torch.long))


def rasterize(
    pos: torch.Tensor,
    tri: torch.Tensor,
    resolution: Tuple[int, int],
    config: RasterizerConfig = DEFAULT_CONFIG,
    grad_db: bool = True,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Rasterize triangles on ``device`` (the card unless ``device="cpu"``;
    inputs are moved there). pos (B, V, 4) clip positions, tri (T, 3).

    Returns (B, H, W, 4) with channels (u, v, z/w, tri_id + 1), 0 on
    background; ``grad_db`` is accepted for signature parity (see
    :func:`rasterize_db`)."""
    del grad_db
    pos, tri = _classic_inputs(pos, tri, config, device)
    height, width = resolution
    return _rasterize_batched(pos, tri, height, width, config)


def rasterize_db(
    pos: torch.Tensor,
    tri: torch.Tensor,
    resolution: Tuple[int, int],
    config: RasterizerConfig = DEFAULT_CONFIG,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize with image-space barycentric derivatives on ``device``.
    Returns (rast (B, H, W, 4), rast_db (B, H, W, 4)); rast_db channels are
    (du/dX, du/dY, dv/dX, dv/dY), zero on background, from the planes of a
    setup without backface culling, as the JAX package derives them."""
    pos, tri = _classic_inputs(pos, tri, config, device)
    height, width = resolution
    rast = _rasterize_batched(pos, tri, height, width, config)
    setup = _triangle_setup(pos, tri, width, height)
    return rast, _resolve_db(setup, rast[..., 3].to(torch.int32))


def _diff_barycentrics(pos: torch.Tensor, tri: torch.Tensor, tid: torch.Tensor,
                       height: int, width: int):
    """Differentiable (u, v, z/w) of the fixed winner triangles: pos
    (B, V, 4) clip positions, tid (B, H, W) winner ids + 1 (0 background,
    constant). Perspective-correct barycentrics at the pixel centres from
    each winner's corners, in the JAX package's expressions, clamps and
    order: ``u = e1/w1 / sum_i e_i/w_i``, ``v = e2/w2 / ...``,
    ``z = sum_i e_i z_i/w_i / sum_i e_i``, with e_i the screen-space
    sub-triangle areas at the pixel centre."""
    b = pos.shape[0]
    t = torch.clamp(tid - 1, min=0).long()
    bidx = torch.arange(b, device=pos.device)[:, None, None, None]
    corners = pos[bidx, tri[t]]  # (B, H, W, 3, 4)
    w = corners[..., 3]
    w_safe = torch.where(w.abs() < _W_EPS, _W_EPS, w)
    inv_w = 1.0 / w_safe
    x = (corners[..., 0] * inv_w + 1.0) * (width * 0.5)  # (B, H, W, 3)
    y = (corners[..., 1] * inv_w + 1.0) * (height * 0.5)
    zw = corners[..., 2] * inv_w
    px = torch.arange(width, dtype=torch.float32, device=pos.device)[None, None, :] + 0.5
    py = torch.arange(height, dtype=torch.float32, device=pos.device)[None, :, None] + 0.5
    # e_i = cross(v_prv - v_nxt, p - v_nxt): the barycentric numerator of i.
    e = []
    for i in range(3):
        nxt, prv = (i + 1) % 3, (i + 2) % 3
        dx = x[..., prv] - x[..., nxt]
        dy = y[..., prv] - y[..., nxt]
        e.append(dx * (py - y[..., nxt]) - dy * (px - x[..., nxt]))
    e_sum = e[0] + e[1] + e[2]
    e_sum = torch.where(e_sum.abs() < 1e-20, 1e-20, e_sum)
    d = e[0] * inv_w[..., 0] + e[1] * inv_w[..., 1] + e[2] * inv_w[..., 2]
    d = torch.where(d.abs() < 1e-30, 1e-30, d)
    u = e[1] * inv_w[..., 1] / d
    v = e[2] * inv_w[..., 2] / d
    z = (e[0] * zw[..., 0] + e[1] * zw[..., 1] + e[2] * zw[..., 2]) / e_sum
    return u, v, z


class _StraightThrough(torch.autograd.Function):
    """The rasterizer's (u, v, z/w, id + 1) unchanged; the gradient of
    channels 0-2 goes to the recomputed u, v and z, channel 3 gets none."""

    @staticmethod
    def forward(ctx, rast, u, v, z):
        return rast.clone()

    @staticmethod
    def backward(ctx, grad):
        return None, grad[..., 0], grad[..., 1], grad[..., 2]


def rasterize_diff(
    pos: torch.Tensor,
    tri: torch.Tensor,
    resolution: Tuple[int, int],
    config: RasterizerConfig = DEFAULT_CONFIG,
    device: DeviceLike = None,
) -> torch.Tensor:
    """:func:`rasterize` with vertex-position gradients (nvdiffrast's
    model) on ``device`` (the card unless ``device="cpu"``).

    Coverage, the winner id image, is treated as fixed; (u, v, z/w) carry
    the analytic gradients w.r.t. the clip positions ``pos`` through a
    perspective-correct barycentric recompute of each covered pixel's
    winner (zero on background). Silhouette gradients come from
    :func:`..antialias.antialias`. The values are :func:`rasterize`'s bit
    for bit: the recompute only carries the gradient."""
    pos, tri = _classic_inputs(pos, tri, config, device)
    height, width = resolution
    rast = _rasterize_batched(pos.detach(), tri, height, width, config)
    tid = rast[..., 3].to(torch.int32)
    u, v, z = _diff_barycentrics(pos, tri, tid, height, width)
    covered = (tid > 0).to(torch.float32)
    return _StraightThrough.apply(rast, u * covered, v * covered, z * covered)
