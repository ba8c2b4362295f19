"""Ray, Plücker and depth back-projection geometry (PyTorch counterpart of
``worldrenderer_tpu/geometry.py``).

Every contraction is exact fp32: the 4-term affine transforms and the
3-term rotations are chains of fused multiply-adds (``fma_f32``), as XLA
evaluates the JAX package's fp32 dots on the CPU, never a TF32 matmul.
Divisions by a Python number divide by a tensor of it: over a Python
number the card multiplies by its rounded reciprocal instead.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .camera import normalize
from .ops.tensor import fma_dot3
from .transforms import fma_f32

__all__ = [
    "get_position_map_from_depth",
    "get_position_map_from_depth_ortho",
    "get_ray_directions",
    "get_rays",
    "compute_plucker_embed",
    "get_opencv_from_blender",
    "get_plucker_embeds_from_cameras",
    "get_plucker_embeds_from_cameras_ortho",
]


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as a true fp32 division on every device."""
    return x / torch.full_like(x, s)


def _affine_points(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) matrices times the points (x, y, z, 1), each (B, H, W):
    the first three rows, (B, H, W, 3), as
    ``fma(m2, z, fma(m1, y, m0 * x)) + m3``."""
    m = m[:, None, None, :3, :]  # (B, 1, 1, 3, 4)
    x, y, z = (t[..., None].double() for t in (x, y, z))
    acc = (m[..., 0].double() * x).float()
    acc = fma_f32(m[..., 1].double(), y, acc.double())
    acc = fma_f32(m[..., 2].double(), z, acc.double())
    return acc + m[..., 3]


def get_position_map_from_depth(
    depth: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    extrinsics: torch.Tensor,
    image_wh: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Back-project (B, H, W, 1) depth maps to (B, H, W, 3) world positions
    with pinhole intrinsics (B, 3, 3) and c2w extrinsics (B, 4, 4), zero
    where ``mask`` (B, H, W, 1) is."""
    if image_wh is None:
        image_wh = depth.shape[2], depth.shape[1]
    depth = depth[..., 0]
    u = torch.arange(image_wh[0], dtype=depth.dtype, device=depth.device)[None, None, :]
    v = torch.arange(image_wh[1], dtype=depth.dtype, device=depth.device)[None, :, None]
    fx = intrinsics[:, 0, 0][:, None, None]
    fy = intrinsics[:, 1, 1][:, None, None]
    cx = intrinsics[:, 0, 2][:, None, None]
    cy = intrinsics[:, 1, 2][:, None, None]
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    return _affine_points(extrinsics, x, y, depth) * mask


def get_position_map_from_depth_ortho(
    depth: torch.Tensor,
    mask: torch.Tensor,
    extrinsics: torch.Tensor,
    ortho_scale,
    image_wh: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Orthographic :func:`get_position_map_from_depth`: ``ortho_scale``
    is the view's extent, one number or one per view."""
    if image_wh is None:
        image_wh = depth.shape[2], depth.shape[1]
    depth = depth[..., 0]
    u = torch.arange(image_wh[0], dtype=depth.dtype, device=depth.device)[None, None, :]
    v = torch.arange(image_wh[1], dtype=depth.dtype, device=depth.device)[None, :, None]
    ortho = torch.as_tensor(ortho_scale, dtype=depth.dtype,
                            device=depth.device).reshape(-1, 1, 1)
    x = _div((u - image_wh[0] / 2.0) * ortho, float(image_wh[0]))
    y = _div((v - image_wh[1] / 2.0) * ortho, float(image_wh[1]))
    x = torch.broadcast_to(x, depth.shape)
    y = torch.broadcast_to(y, depth.shape)
    return _affine_points(extrinsics, x, y, depth) * mask


def get_ray_directions(
    height: int,
    width: int,
    focal: float,
    principal: Optional[Tuple[float, float]] = None,
    use_pixel_centers: bool = True,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(H, W, 3) normalized camera-frame ray directions, -z forward, on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    center = 0.5 if use_pixel_centers else 0.0
    cx, cy = (width / 2.0, height / 2.0) if principal is None else principal
    i = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + center
    j = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + center
    i = torch.broadcast_to(i, (height, width))
    j = torch.broadcast_to(j, (height, width))
    dirs = torch.stack([_div(i - cx, focal), -_div(j - cy, focal),
                        -torch.ones_like(i)], dim=-1)
    return normalize(dirs)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Camera-frame ray directions (..., 3) rotated into the world by a
    (4, 4) c2w; the origins are its translation. Returns (rays_o, rays_d)."""
    rays_d = fma_dot3(directions[..., None, :], c2w[:3, :3], -1)
    rays_o = torch.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o, rays_d


def compute_plucker_embed(c2w: torch.Tensor, image_width: int,
                          image_height: int, focal: float) -> torch.Tensor:
    """(6, H, W) Plücker embedding (d, o x d) of a camera's ray bundle."""
    directions = get_ray_directions(image_height, image_width, focal,
                                    device=c2w.device)
    rays_o, rays_d = get_rays(directions, c2w)
    cross = torch.linalg.cross(rays_o, rays_d, dim=-1)
    return torch.cat([rays_d, cross], dim=-1).permute(2, 0, 1)


def get_opencv_from_blender(matrix_world, fov: Optional[float] = None,
                            image_size: Optional[int] = None):
    """A Blender camera's world matrix -> OpenCV extrinsics (rotation,
    translation), and intrinsics when ``fov`` is given (perspective): the
    inverse with the camera's Y and Z rows negated. The inverse is taken on
    the host in float64, so every device gets the same bits."""
    m = torch.as_tensor(matrix_world, dtype=torch.float32)
    w2c = torch.linalg.inv(m.detach().cpu().double()).float()
    w2c[1, :] *= -1.0
    w2c[2, :] *= -1.0
    w2c = w2c.to(m.device)
    rot, trans = w2c[:3, :3], w2c[:3, 3]
    if fov is None:  # orthographic camera
        return rot, trans
    focal = 1.0 / math.tan(fov / 2.0)
    half = np.float32(image_size / 2.0)
    intr = np.diag(np.array([focal, focal, 1.0], np.float32))
    intr[:2, -1] += half
    intr[0, 0] *= half
    intr[1, 1] *= half
    return rot[None], trans[None], torch.from_numpy(intr[None]).to(m.device)


def get_plucker_embeds_from_cameras(c2w, fov, image_size: int) -> torch.Tensor:
    """(B, 6, H, W) Plücker embeddings of perspective cameras: (B, 4, 4)
    c2w, B vertical fovs in radians."""
    return torch.stack([
        compute_plucker_embed(torch.as_tensor(m, dtype=torch.float32),
                              image_size, image_size,
                              0.5 * image_size / math.tan(0.5 * float(f)))
        for m, f in zip(c2w, fov)
    ])


def get_plucker_embeds_from_cameras_ortho(c2w, ortho_scale,
                                          image_size: int) -> torch.Tensor:
    """(B, 6, H, W) constant Plücker embeddings of orthographic cameras:
    each camera's [view direction, normalized position] over the image."""
    embeds = []
    for m, _scale in zip(c2w, ortho_scale):
        rot, trans = get_opencv_from_blender(m)
        rot_t = rot.T.contiguous()
        cam_pos = -fma_dot3(rot_t, trans[None, :], -1)
        z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=rot.device)
        view_dir = fma_dot3(rot_t, z[None, :], -1)
        plucker = torch.cat([view_dir, normalize(cam_pos, axis=0)])  # (6,)
        embeds.append(torch.broadcast_to(plucker[:, None, None],
                                         (6, image_size, image_size)))
    return torch.stack(embeds)
