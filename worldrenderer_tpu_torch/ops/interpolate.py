"""Barycentric attribute interpolation, the nvdiffrast ``interpolate``
(PyTorch counterpart of ``worldrenderer_tpu/ops/interpolate.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .._device import DeviceLike, resolve_device
from ..utils.debug import annotate

__all__ = ["interpolate"]


def interpolate(
    attr: torch.Tensor,
    rast: torch.Tensor,
    tri: torch.Tensor,
    rast_db: Optional[torch.Tensor] = None,
    diff_attrs: Optional[Union[str, Sequence[int]]] = None,
    device: DeviceLike = None,
):
    """Interpolate vertex attributes over a rasterized image on ``device``
    (the card unless ``device="cpu"``; inputs are moved there).

    attr (B, V, C) or (1, V, C), broadcast over the views; rast
    (B, H, W, 4) from ``rasterize``; tri (T, 3); rast_db (B, H, W, 4) from
    ``rasterize_db``; diff_attrs: channel indices to differentiate, or
    ``"all"``.

    Returns (B, H, W, C), 0 on background. With ``diff_attrs`` it returns
    (out, out_da), out_da (B, H, W, 2 * len(diff_attrs)) holding (dA/dX,
    dA/dY) per selected channel: A = a0 + u*(a1-a0) + v*(a2-a0), so dA/dX =
    (a1-a0)*du/dX + (a2-a0)*dv/dX exactly."""
    with annotate("wr::interpolate"):
        return _interpolate(attr, rast, tri, rast_db, diff_attrs,
                            resolve_device(device))


def _interpolate(attr, rast, tri, rast_db, diff_attrs, dev):
    attr = torch.as_tensor(attr, dtype=torch.float32, device=dev)
    if attr.ndim != 3:
        raise ValueError("attr must be (B, V, C)")
    rast = rast.to(device=dev, dtype=torch.float32)
    tri = tri.to(device=dev, dtype=torch.long)
    b = rast.shape[0]
    if attr.shape[0] == 1 and b > 1:
        attr = attr.expand(b, *attr.shape[1:])

    u = rast[..., 0]
    v = rast[..., 1]
    idx = rast[..., 3].to(torch.int32)  # tri_id + 1, 0 = background
    verts = tri[torch.clamp(idx - 1, min=0).long()]  # (B, H, W, 3)
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    a = attr[bidx, verts]  # (B, H, W, 3, C)
    w0 = (1.0 - u - v)[..., None]
    out = a[..., 0, :] * w0 + a[..., 1, :] * u[..., None] + a[..., 2, :] * v[..., None]
    mask = (idx > 0)[..., None]
    out = torch.where(mask, out, 0.0)
    if diff_attrs is None:
        return out

    if rast_db is None:
        raise ValueError("diff_attrs requires rast_db (use rasterize_db)")
    if isinstance(diff_attrs, str):
        if diff_attrs != "all":
            raise ValueError(f"unknown diff_attrs {diff_attrs!r}")
        sel = list(range(attr.shape[-1]))
    else:
        sel = list(diff_attrs)
    rast_db = rast_db.to(device=dev, dtype=torch.float32)
    da_u = a[..., 1, sel] - a[..., 0, sel]  # (B, H, W, S)
    da_v = a[..., 2, sel] - a[..., 0, sel]
    d_dx = da_u * rast_db[..., 0:1] + da_v * rast_db[..., 2:3]
    d_dy = da_u * rast_db[..., 1:2] + da_v * rast_db[..., 3:4]
    out_da = torch.stack([d_dx, d_dy], dim=-1).reshape(
        d_dx.shape[:-1] + (2 * len(sel),)
    )
    return out, torch.where(mask, out_da, 0.0)
