"""Differentiable grid-mesh image warp: align input photos to rendered views
(PyTorch counterpart of ``worldrenderer_tpu/baking/warp.py``).

A regular (n_grid x n_grid) NDC grid whose interior vertices are fitted
with Adam, coarse to fine, to minimise the photometric L2 against the
rendered target plus an edge-length regulariser; the fitted grid then warps
the source image (bicubic).

* All views fit together: one (Nv, (n+1)^2, 2) offset, one Adam, and the
  loss is the sum of each view's own loss. Adam is elementwise, so this is
  the JAX package's ``vmap`` of Nv separate fits.
* The regulariser pulls each edge toward its rest length (the JAX
  package's corrected form, not the reference's endpoint typo).
* A grid's per-pixel position is analytic: no rasterizer.
* The resize is ``jax.image.resize(method="linear", antialias=True)``:
  separable triangle weights, widened by 1/scale when downsampling,
  normalised per output sample, zero outside the input, applied as two
  fp32 contractions (TF32 off). ``F.interpolate(antialias=True)`` weighs
  the edges as PIL does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..ops.grid_sample import grid_sample
from ..transforms import norm
from ..utils.debug import count

__all__ = ["construct_grid_mesh", "compute_warp_field"]


def construct_grid_mesh(n_grid: int):
    """(n_grid+1)^2-vertex NDC grid in [-1, 1]^2 with z = 0, clockwise-split
    quads, the unique undirected edges and the interior-vertex mask
    (numpy: verts, faces, edges, movable)."""
    ii, jj = np.meshgrid(np.arange(n_grid + 1), np.arange(n_grid + 1), indexing="xy")
    verts = np.stack(
        [ii / n_grid, jj / n_grid, np.full_like(ii, 0.5, dtype=np.float64)], axis=-1
    ).reshape(-1, 3)
    verts = 2.0 * verts - 1.0
    movable = ((ii > 0) & (ii < n_grid) & (jj > 0) & (jj < n_grid)).reshape(-1)

    idx = np.arange((n_grid + 1) ** 2).reshape(n_grid + 1, n_grid + 1)
    f0 = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1]], axis=-1)
    f1 = np.stack([idx[:-1, 1:], idx[1:, 1:], idx[1:, :-1]], axis=-1)
    faces = np.concatenate([f0.reshape(-1, 3), f1.reshape(-1, 3)], axis=0)

    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    edges = np.unique(np.sort(e, axis=1), axis=0)
    return verts, faces.astype(np.int64), edges.astype(np.int64), movable


def _grid_pixel_coords(verts_xy: torch.Tensor, n_grid: int, res: int) -> torch.Tensor:
    """Warped NDC coordinates of each pixel centre of a res x res image:
    (..., (n+1)^2, 2) grid vertex positions -> (..., res, res, 2), linear
    within the grid triangle that holds the centre (the faces' split:
    (v00, v10, v01) and (v10, v11, v01))."""
    lead = verts_xy.shape[:-2]
    v = verts_xy.reshape(*lead, n_grid + 1, n_grid + 1, 2)  # [row j (y), col i (x)]
    dev = verts_xy.device
    p = torch.arange(res, dtype=torch.float32, device=dev) + 0.5
    p = p / torch.full_like(p, float(res)) * n_grid  # a true division
    gy, gx = torch.meshgrid(p, p, indexing="ij")  # (res, res)
    i0 = torch.clamp(torch.floor(gx).long(), 0, n_grid - 1)
    j0 = torch.clamp(torch.floor(gy).long(), 0, n_grid - 1)
    fx = (gx - i0.float())[..., None]
    fy = (gy - j0.float())[..., None]

    v00 = v[..., j0, i0, :]
    v10 = v[..., j0, i0 + 1, :]
    v01 = v[..., j0 + 1, i0, :]
    v11 = v[..., j0 + 1, i0 + 1, :]
    lower = fx + fy <= 1.0
    tri_lower = v00 + fx * (v10 - v00) + fy * (v01 - v00)
    tri_upper = v11 + (1.0 - fx) * (v01 - v11) + (1.0 - fy) * (v10 - v11)
    return torch.where(lower, tri_lower, tri_upper)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel (a = -0.5) at distances x >= 0, in
    ``jax.image.resize``'s order of operations."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in: int, n_out: int, device,
                    kernel: str = "linear") -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize``'s antialiased
    ``kernel`` ("linear" or "cubic") along one axis, computed in fp32 as
    ``compute_weight_mat`` computes them: the taps widened by 1/scale when
    downsampling, renormalised to sum to 1 per output sample (so the taps
    that fall outside the input at the edges are dropped, not clamped), and
    zero where the sample lies outside the input."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample_f = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.0 - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, **f32)[:, None]).abs()
    x = x / torch.full_like(x, kernel_scale)
    if kernel == "cubic":
        weights = _keys_cubic(x)
    elif kernel == "linear":
        weights = torch.clamp(1.0 - x.abs(), min=0.0)
    else:
        raise ValueError(f"unknown resize kernel {kernel!r}")
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_hw(img: torch.Tensor, height: int, width: int,
              kernel: str = "linear") -> torch.Tensor:
    """Antialiased resize of (..., H, W, C) to (..., height, width, C), as
    ``jax.image.resize(method=kernel, antialias=True)``: one fp32
    contraction per axis that changes (TF32 off on the card); an axis
    already at its size is left as it is."""
    h, w = img.shape[-3], img.shape[-2]
    if h != height:
        wy = _resize_weights(h, height, img.device, kernel)
        img = torch.einsum("...hwc,hi->...iwc", img, wy)
    if w != width:
        wx = _resize_weights(w, width, img.device, kernel)
        img = torch.einsum("...hwc,wj->...hjc", img, wx)
    return img


def compute_warp_field(
    src_images,
    tgt_images,
    n_grid: int = 10,
    optim_res: Sequence[int] = (64, 128),
    optim_step_per_res: int = 20,
    lambda_reg: float = 2.0,
    lr: float = 0.02,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Warp each square src image toward its tgt image on ``device`` (the
    card unless ``device="cpu"``). (Nv, H, H, C) -> the same shape, in
    [0, 1]. Each resolution of ``optim_res`` runs ``optim_step_per_res``
    Adam steps from the previous stage's offsets with a fresh Adam."""
    dev = resolve_device(device)
    src = torch.as_tensor(src_images, dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(tgt_images, dtype=torch.float32, device=dev)
    verts_np, _faces, edges_np, movable_np = construct_grid_mesh(n_grid)
    count("host_sync.warp_grid", 3)  # three copies from the host
    verts0 = torch.tensor(verts_np[:, :2], dtype=torch.float32, device=dev)
    edges = torch.tensor(edges_np, device=dev)
    movable = torch.tensor(movable_np, dtype=torch.float32, device=dev)[:, None]

    def edge_len(v):
        return norm(v[..., edges[:, 0], :] - v[..., edges[:, 1], :])

    rest_len = edge_len(verts0)
    delta = torch.zeros((src.shape[0],) + verts0.shape, device=dev)
    for res in optim_res:
        res = int(res)
        src_r = resize_hw(src[..., :3], res, res)
        tgt_r = resize_hw(tgt[..., :3], res, res)
        delta = delta.detach().requires_grad_(True)
        opt = torch.optim.Adam([delta], lr=lr)
        for _ in range(optim_step_per_res):
            verts = verts0 + movable * delta
            coords = _grid_pixel_coords(verts, n_grid, res)
            warped = grid_sample(src_r, coords, mode="bilinear", device=dev)
            img_loss = ((warped - tgt_r) ** 2).mean(dim=(1, 2, 3))
            reg = ((edge_len(verts) - rest_len) ** 2).mean(dim=-1)
            loss = (img_loss + lambda_reg * reg).sum()
            opt.zero_grad()
            loss.backward()
            opt.step()

    with torch.no_grad():
        verts = verts0 + movable * delta
        coords = _grid_pixel_coords(verts, n_grid, src.shape[1])
        warped = grid_sample(src, coords, mode="bicubic", device=dev)
        return torch.clamp(warped, 0.0, 1.0)
