"""Analytic silhouette-edge antialiasing, the nvdiffrast ``antialias``
(PyTorch counterpart of ``worldrenderer_tpu/ops/antialias.py``).

The rasterizer's edge functions are screen-affine planes, so for a pair of
horizontally adjacent pixels the inside triangle's edge value at the
neighbour's centre is ``e + a`` (``e + b`` vertically): one gather of each
pixel's winning triangle's planes and the pass is elementwise.

* For each adjacent pair with differing ids, the front (inside) pixel's
  triangle has every e_i >= 0 at its own centre; the edge crossing the
  segment toward the outside pixel sits at
  ``t = min_i e_in_i / (e_in_i - e_out_i)`` over the edges with
  e_out_i < 0.
* ``t > 0.5``: the triangle covers part of the outside pixel, which blends
  toward the inside colour by ``t - 0.5``; ``t <= 0.5``: the inside pixel is
  partly uncovered and blends outward by ``0.5 - t``.
* The gate is geometric: background on one side, or a relative depth jump.

Without ``pos`` / ``tri`` a screen-space approximation blends silhouette
pixels toward their neighbours (0.5 coverage, the same gate).
"""

from __future__ import annotations

from typing import Optional

import torch

from .._device import DeviceLike, resolve_device
from .rasterize import _triangle_setup

__all__ = ["antialias"]


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift (B, H, W, ...) by (dy, dx) with edge replication:
    out[y, x] = x[clip(y - dy), clip(x - dx)]."""
    if dy > 0:
        x = torch.cat([x[:, :1].expand(-1, dy, *x.shape[2:]), x[:, :-dy]], dim=1)
    elif dy < 0:
        x = torch.cat([x[:, -dy:], x[:, -1:].expand(-1, -dy, *x.shape[2:])], dim=1)
    if dx > 0:
        x = torch.cat([x[:, :, :1].expand(-1, -1, dx, *x.shape[3:]), x[:, :, :-dx]],
                      dim=2)
    elif dx < 0:
        x = torch.cat([x[:, :, -dx:], x[:, :, -1:].expand(-1, -1, -dx, *x.shape[3:])],
                      dim=2)
    return x


def _silhouette(tid, tid_n, z, z_n):
    """Ids differ AND (background on one side OR a relative depth jump)."""
    diff_id = tid_n != tid
    bg_edge = (tid == 0) | (tid_n == 0)
    scale = torch.clamp(torch.maximum(z.abs(), z_n.abs()), min=1e-3)
    depth_jump = (z_n - z).abs() > 0.01 * scale
    return diff_id & (bg_edge | depth_jump)


def _antialias_analytic(color, rast, pos, tri):
    """Analytic edge-crossing blend, batched over views."""
    b, h, w, _ = color.shape
    tid = rast[..., 3].to(torch.int32)  # (B, H, W), 0 = background
    z = rast[..., 2]
    setup = _triangle_setup(pos, tri, w, h)
    bidx = torch.arange(b, device=color.device)[:, None, None]
    planes = setup.planes[bidx, torch.clamp(tid - 1, min=0).long(), :3]  # (B,H,W,3,3)
    px = torch.arange(w, dtype=torch.float32, device=color.device) + 0.5
    py = torch.arange(h, dtype=torch.float32, device=color.device) + 0.5
    e_own = (planes[..., 0] * px[None, None, :, None]
             + planes[..., 1] * py[None, :, None, None]
             + planes[..., 2])  # (B, H, W, 3): own winner's edges at own centre
    delta = torch.zeros_like(color)

    for axis, coef in ((2, 0), (1, 1)):  # x pairs step by a, y pairs by b
        n = color.shape[axis]

        def sl(t, start):  # pixels p (start 0) or their neighbours q (1)
            return t.narrow(axis, start, n - 1)

        tid_p, tid_q = sl(tid, 0), sl(tid, 1)
        z_p, z_q = sl(z, 0), sl(z, 1)
        sil = _silhouette(tid_p, tid_q, z_p, z_q)
        # The inside pixel is the front one (background never is).
        p_in = (tid_p > 0) & ((tid_q == 0) | (z_p <= z_q))
        pin = p_in[..., None]
        e_p, e_q = sl(e_own, 0), sl(e_own, 1)
        e_in = torch.where(pin, e_p, e_q)
        e_out = torch.where(pin, e_p + sl(planes, 0)[..., coef],
                            e_q - sl(planes, 1)[..., coef])
        # First exit crossing along the unit segment; a finite sentinel and
        # a guarded division keep inf and NaN out of unselected branches.
        crossing = (e_out < 0) & (e_in >= 0)
        denom = torch.where(crossing, e_in - e_out, 1.0)
        t_i = torch.where(crossing, e_in / torch.clamp(denom, min=1e-20), 2.0)
        t = t_i.amin(dim=-1)
        ok = sil & (t <= 1.0)

        c_p, c_q = sl(color, 0), sl(color, 1)
        c_in = torch.where(pin, c_p, c_q)
        c_out = torch.where(pin, c_q, c_p)
        w_out = torch.where(ok, torch.clamp(t - 0.5, min=0.0), 0.0)
        w_in = torch.where(ok, torch.clamp(0.5 - t, min=0.0), 0.0)
        d_out = (c_in - c_out) * w_out[..., None]
        d_in = (c_out - c_in) * w_in[..., None]
        d_p = torch.where(pin, d_in, d_out)
        d_q = torch.where(pin, d_out, d_in)
        zero = torch.zeros_like(d_p.narrow(axis, 0, 1))
        delta = delta + torch.cat([d_p, zero], dim=axis)
        delta = delta + torch.cat([zero, d_q], dim=axis)
    return color + delta


def antialias(
    color: torch.Tensor,
    rast: torch.Tensor,
    pos: Optional[torch.Tensor] = None,
    tri: Optional[torch.Tensor] = None,
    topology_hash=None,
    pos_gradient_boost: float = 1.0,
    strength: float = 0.5,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Antialias ``color`` (B, H, W, C) along the silhouette edges of
    ``rast`` (B, H, W, 4, from ``rasterize``) on ``device`` (the card
    unless ``device="cpu"``; the inputs are moved there).

    With ``pos`` (B, V, 4) clip positions and ``tri`` (T, 3): analytic
    edge-crossing weights (``topology_hash`` and ``pos_gradient_boost`` are
    accepted for API parity). Without them: silhouette pixels blend
    ``strength`` / 2 toward the neighbour across the edge."""
    del topology_hash, pos_gradient_boost  # parity arguments
    dev = resolve_device(device)
    color = torch.as_tensor(color, dtype=torch.float32, device=dev)
    rast = torch.as_tensor(rast, dtype=torch.float32, device=dev)
    if pos is not None and tri is not None:
        return _antialias_analytic(
            color, rast, torch.as_tensor(pos, dtype=torch.float32, device=dev),
            torch.as_tensor(tri, dtype=torch.long, device=dev))

    tid = rast[..., 3].to(torch.int32)
    z = rast[..., 2]
    total_w = torch.ones_like(z)
    accum = color
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        sil = _silhouette(tid, _shift(tid, dy, dx), z, _shift(z, dy, dx))
        w_ = sil.to(color.dtype) * strength * 0.25
        accum = accum + _shift(color, dy, dx) * w_[..., None]
        total_w = total_w + w_
    return accum / total_w[..., None]
