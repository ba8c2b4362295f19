"""A plain triangle rasterizer in float64: the reference that the
benchmark holds the program's renders and bakes against.

It imports nothing of the program. Semantics (those of the program's
documented contract, written out independently): the clip transform
``mvp @ [v, 1]``; pixel (i, j) samples the point (i + 0.5, j + 0.5) in
pixel units, x = (x_c / w + 1) W / 2, y = (y_c / w + 1) H / 2 (row j is y);
a triangle covers a pixel when its three edge functions, signed by the
triangle's area, are all >= 0 there and its screen-linear NDC z lies in
[-1, 1]; the least z wins, the lowest triangle id on equal z; attributes
are interpolated perspective-correctly. Zero-area triangles and
triangles wholly behind w = 1e-8 cover nothing; a triangle crossing the
w = 1e-8 plane is refused (the program renders it by homogeneous
planes, which this reference does not model, and no traffic of the
benchmark makes one). ``cull`` +1 / -1 drops triangles of negative /
positive screen area, as the program's ``backface_cull``.

``tf32=True`` rounds both operands of the clip transform to TF32's
10-bit mantissa first: the control that stands for a TF32 matmul. The
clip positions' dtype (``clip_positions``' ``dtype``, float64 by default)
is the dtype of every later step: float32 gives the same reference at the
program's precision, a witness of what rounding alone does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

W_EPS = 1e-8
# Candidate (triangle, pixel) pairs per block: bounds the memory of a pass.
MAX_PAIRS = 1 << 23


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits (to nearest,
    ties away from zero), as a tensor core reads an fp32 operand."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def clip_positions(v_pos: torch.Tensor, mvp: torch.Tensor,
                   tf32: bool = False,
                   dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(N, 3) vertices through (V, 4, 4) matrices: (V, N, 4) ``dtype``."""
    if tf32:
        v_pos, mvp = round_tf32(v_pos), round_tf32(mvp)
    v = v_pos.to(dtype)
    vh = torch.cat([v, torch.ones_like(v[:, :1])], dim=1)
    return torch.einsum("vij,nj->vni", mvp.to(dtype), vh)


class Coverage(NamedTuple):
    tri_id: torch.Tensor  # (H, W) long, -1 = background
    # The covering candidates before depth resolution, for work counts.
    pair_tri: Optional[torch.Tensor]
    pair_pix: Optional[torch.Tensor]


def screen(clip: torch.Tensor, tri: torch.Tensor, height: int, width: int):
    """Per triangle: corner x, y (pixel units), NDC z and w, each (T, 3);
    the signed screen area (T,); and whether the triangle can cover."""
    c = clip[tri]  # (T, 3, 4)
    w = c[..., 3]
    front = (w > W_EPS).all(dim=1)
    crossing = (w > W_EPS).any(dim=1) & ~front
    if bool(crossing.any()):
        raise ValueError(f"{int(crossing.sum())} triangles cross the w = "
                         f"{W_EPS} plane; the reference does not clip")
    w_safe = torch.where(front[:, None], w, torch.ones_like(w))
    x = (c[..., 0] / w_safe + 1.0) * (width * 0.5)
    y = (c[..., 1] / w_safe + 1.0) * (height * 0.5)
    z = c[..., 2] / w_safe
    area = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
            - (y[:, 1] - y[:, 0]) * (x[:, 2] - x[:, 0]))
    return x, y, z, w_safe, area, front & (area != 0)


def _edges(x, y, px, py):
    """Edge functions e_i: twice the signed area of (p, v_{i+1}, v_{i+2});
    e_i / area is the screen barycentric of vertex i."""
    x0, x1, x2 = x[:, 0], x[:, 1], x[:, 2]
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    e0 = (x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)
    e1 = (x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)
    e2 = (x0 - px) * (y1 - py) - (x1 - px) * (y0 - py)
    return e0, e1, e2


def rasterize(clip: torch.Tensor, tri: torch.Tensor, height: int, width: int,
              cull: int = 0, keep_pairs: bool = False) -> Coverage:
    """One view: (N, 4) clip positions, (T, 3) triangles."""
    dev = clip.device
    x, y, z, _, area, valid = screen(clip, tri, height, width)
    if cull:
        valid = valid & ~(area * cull < 0)
    ix0 = torch.ceil(x.amin(1) - 0.5).clamp(min=0)
    ix1 = torch.floor(x.amax(1) - 0.5).clamp(max=width - 1)
    iy0 = torch.ceil(y.amin(1) - 0.5).clamp(min=0)
    iy1 = torch.floor(y.amax(1) - 0.5).clamp(max=height - 1)
    nx = (ix1 - ix0 + 1).clamp(min=0).long()
    ny = (iy1 - iy0 + 1).clamp(min=0).long()
    cnt = torch.where(valid, nx * ny, torch.zeros_like(nx))
    ids = torch.nonzero(cnt > 0).squeeze(1)
    cnt_ids = cnt[ids]
    ends = torch.cumsum(cnt_ids, 0)
    # Block boundaries on the host, one read.
    bounds = [0]
    if ids.numel():
        ends_h = ends.cpu()
        start = 0
        while start < ids.numel():
            base = int(ends_h[start - 1]) if start else 0
            stop = int(torch.searchsorted(ends_h, base + MAX_PAIRS, right=True))
            stop = max(stop, start + 1)
            bounds.append(stop)
            start = stop
    keep_t, keep_p, keep_z = [], [], []
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        t_ids, c_ids = ids[b0:b1], cnt_ids[b0:b1]
        t = torch.repeat_interleave(t_ids, c_ids)
        first = torch.cumsum(c_ids, 0) - c_ids
        off = torch.arange(t.numel(), device=dev) - torch.repeat_interleave(first, c_ids)
        nx_t = nx[t]
        pxi = ix0[t].long() + off % nx_t
        pyi = iy0[t].long() + off // nx_t
        px = pxi.to(clip.dtype) + 0.5
        py = pyi.to(clip.dtype) + 0.5
        xt, yt = x[t], y[t]
        e0, e1, e2 = _edges(xt, yt, px, py)
        at = area[t]
        s = torch.sign(at)
        inside = (e0 * s >= 0) & (e1 * s >= 0) & (e2 * s >= 0)
        zt = z[t]
        zz = (e0 * zt[:, 0] + e1 * zt[:, 1] + e2 * zt[:, 2]) / at
        inside = inside & (zz >= -1.0) & (zz <= 1.0)
        keep_t.append(t[inside])
        keep_p.append((pyi * width + pxi)[inside])
        keep_z.append(zz[inside])
    n_pix = height * width
    t_all = torch.cat(keep_t) if keep_t else torch.zeros(0, dtype=torch.long, device=dev)
    p_all = torch.cat(keep_p) if keep_p else torch.zeros(0, dtype=torch.long, device=dev)
    z_all = torch.cat(keep_z) if keep_z else torch.zeros(0, dtype=clip.dtype, device=dev)
    zbuf = torch.full((n_pix,), float("inf"), dtype=clip.dtype, device=dev)
    zbuf = zbuf.scatter_reduce(0, p_all, z_all, "amin")
    best = z_all == zbuf[p_all]
    big = tri.shape[0]
    idbuf = torch.full((n_pix,), big, dtype=torch.long, device=dev)
    idbuf = idbuf.scatter_reduce(0, p_all[best], t_all[best], "amin")
    tri_id = torch.where(idbuf < big, idbuf, -1).reshape(height, width)
    return Coverage(tri_id, t_all if keep_pairs else None,
                    p_all if keep_pairs else None)


def barycentrics(clip: torch.Tensor, tri: torch.Tensor, tri_id: torch.Tensor,
                 height: int, width: int):
    """Perspective-correct barycentrics (P, 3), in ``clip``'s dtype, of the covered
    pixels, and their flat pixel indices (P,)."""
    pix = torch.nonzero(tri_id.reshape(-1) >= 0).squeeze(1)
    t = tri_id.reshape(-1)[pix]
    c = clip[tri[t]]  # (P, 3, 4)
    w = c[..., 3]
    x = (c[..., 0] / w + 1.0) * (width * 0.5)
    y = (c[..., 1] / w + 1.0) * (height * 0.5)
    px = (pix % width).to(clip.dtype) + 0.5
    py = (pix // width).to(clip.dtype) + 0.5
    e = torch.stack(_edges(x, y, px, py), dim=1)  # (P, 3)
    q = e / w
    return q / q.sum(dim=1, keepdim=True), pix


def interpolate(values: torch.Tensor, tri: torch.Tensor, tri_id: torch.Tensor,
                bary: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """(P, C) in ``bary``'s dtype: per-vertex ``values`` (N, C) at the
    covered pixels, over the corners ``tri`` of each pixel's triangle."""
    t = tri_id.reshape(-1)[pix]
    corners = values.to(bary.dtype)[tri[t]]  # (P, 3, C)
    return (bary[..., None] * corners).sum(dim=1)


def vertex_normals(v_pos: torch.Tensor, tri: torch.Tensor,
                   dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Area-weighted vertex normals in ``dtype``: each face's cross product
    summed onto its corners, normalized; +z where the sum vanishes."""
    v = v_pos.to(dtype)
    a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    fn = torch.linalg.cross(b - a, c - a)
    acc = torch.zeros_like(v)
    for k in range(3):
        acc.index_add_(0, tri[:, k], fn)
    nrm = acc.norm(dim=1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device)
    return torch.where(nrm > 1e-10, acc / nrm.clamp(min=1e-300), up)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
