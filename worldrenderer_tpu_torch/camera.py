"""Camera math: orbit look-at construction, projection matrices, the Camera
batch (PyTorch counterpart of ``worldrenderer_tpu/camera.py``).

Conventions match the JAX package so every downstream image matches:
  * world is Z-up; orbit cameras look at the origin;
  * the perspective and orthographic projections have a **negated Y row**,
    so image row 0 is the top of the image.
Every matrix is float32; products run in true fp32 (``resolve_device``
switches TF32 off on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ._device import DeviceLike, as_f32, resolve_device

ArrayLike = Union[torch.Tensor, np.ndarray, Sequence[float], float, int]


def normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12,
              dim: Optional[int] = None) -> torch.Tensor:
    """L2-normalize along ``axis`` (``dim``, PyTorch's name, is an alias):
    x / max(||x||, eps)."""
    norm = torch.linalg.vector_norm(x, dim=axis if dim is None else dim,
                                    keepdim=True)
    return x / torch.clamp(norm, min=eps)


def get_c2w(
    elevation_deg: ArrayLike,
    distance: ArrayLike,
    azimuth_deg: Optional[ArrayLike] = None,
    num_views: Optional[int] = 1,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Orbit camera-to-world matrices, Z-up look-at targeting the origin;
    basis columns are [right, up, -lookat]. Returns (N, 4, 4) float32."""
    if azimuth_deg is None:
        if num_views is None:
            raise ValueError("num_views is required when azimuth_deg is None")
        azimuth_deg = torch.linspace(
            0.0, 360.0, num_views + 1, dtype=torch.float32, device=device
        )[:-1]
    azim_deg = torch.atleast_1d(as_f32(azimuth_deg, device))
    n = azim_deg.shape[0]
    elev_deg = torch.atleast_1d(as_f32(elevation_deg, device)).expand(n)
    dist = torch.atleast_1d(as_f32(distance, device)).expand(n)

    elev = elev_deg * (math.pi / 180.0)
    azim = azim_deg * (math.pi / 180.0)
    cam_pos = torch.stack(
        [
            dist * torch.cos(elev) * torch.cos(azim),
            dist * torch.cos(elev) * torch.sin(azim),
            dist * torch.sin(elev),
        ],
        dim=-1,
    )  # (N, 3)
    up_world = torch.tensor([0.0, 0.0, 1.0], device=device).expand(n, 3)
    lookat = normalize(-cam_pos)
    right = normalize(torch.linalg.cross(lookat, up_world))
    up = normalize(torch.linalg.cross(right, lookat))
    rot = torch.stack([right, up, -lookat], dim=-1)  # (N, 3, 3) columns
    c2w = torch.cat([rot, cam_pos[:, :, None]], dim=-1)  # (N, 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device).expand(n, 1, 4)
    return torch.cat([c2w, bottom], dim=1)


def get_projection_matrix(
    fovy_deg: ArrayLike,
    aspect_wh: float = 1.0,
    near: float = 0.1,
    far: float = 100.0,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """OpenGL-style perspective projection with a negated Y row.
    Returns (N, 4, 4) float32."""
    fovy = torch.atleast_1d(as_f32(fovy_deg, device)) * (math.pi / 180.0)
    n = fovy.shape[0]
    t = torch.tan(fovy / 2.0)
    proj = torch.zeros((n, 4, 4), dtype=torch.float32, device=device)
    proj[:, 0, 0] = 1.0 / (aspect_wh * t)
    proj[:, 1, 1] = -1.0 / t
    proj[:, 2, 2] = -(far + near) / (far - near)
    proj[:, 2, 3] = -2.0 * far * near / (far - near)
    proj[:, 3, 2] = -1.0
    return proj


def get_orthogonal_projection_matrix(
    batch_size: int,
    left: float,
    right: float,
    bottom: float,
    top: float,
    near: float = 0.1,
    far: float = 100.0,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Orthographic projection with a negated Y row. Returns (N, 4, 4)."""
    proj = np.zeros((batch_size, 4, 4), dtype=np.float32)
    proj[:, 0, 0] = 2.0 / (right - left)
    proj[:, 1, 1] = -2.0 / (top - bottom)
    proj[:, 2, 2] = -2.0 / (far - near)
    proj[:, 0, 3] = -(right + left) / (right - left)
    proj[:, 1, 3] = -(top + bottom) / (top - bottom)
    proj[:, 2, 3] = -(far + near) / (far - near)
    proj[:, 3, 3] = 1.0
    return torch.from_numpy(proj).to(device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """A batch of views. Every field is (N, 4, 4) except cam_pos (N, 3);
    ``c2w`` and ``cam_pos`` are None when built from a bare w2c.
    Indexing slices views; ``len`` counts them."""

    c2w: Optional[torch.Tensor]
    w2c: torch.Tensor
    proj_mtx: torch.Tensor
    mvp_mtx: torch.Tensor
    cam_pos: Optional[torch.Tensor]

    def __getitem__(self, index) -> "Camera":
        if isinstance(index, int):
            index = slice(index, index + 1)
        return Camera(
            **{
                f.name: None if getattr(self, f.name) is None
                else getattr(self, f.name)[index]
                for f in dataclasses.fields(self)
            }
        )

    def __len__(self) -> int:
        return self.w2c.shape[0]

    def to(self, device: DeviceLike) -> "Camera":
        return Camera(
            **{
                f.name: None if getattr(self, f.name) is None
                else getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )


def rigid_inverse(mat: torch.Tensor) -> torch.Tensor:
    """Analytic inverse (R^T, -R^T t) of rigid 4x4 transforms. Exact ONLY
    for orthonormal rotation blocks; scaled matrices need
    :func:`affine_inverse`."""
    rot_t = mat[..., :3, :3].transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", rot_t, mat[..., :3, 3])
    inv = torch.cat([rot_t, t_inv[..., None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=mat.dtype, device=mat.device
    ).expand(*inv.shape[:-2], 1, 4)
    return torch.cat([inv, bottom], dim=-2)


def affine_inverse(mat: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of affine 4x4 transforms [A | t; 0 1] through
    the 3x3 adjugate — exact for scaled or sheared camera matrices."""
    a = mat[..., :3, :3].float()
    t = mat[..., :3, 3].float()

    def m(i, j):
        return a[..., i, j]

    c00 = m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1)
    c01 = m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2)
    c02 = m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)
    det = m(0, 0) * c00 + m(0, 1) * c01 + m(0, 2) * c02
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack(
        [
            torch.stack([c00,
                         m(0, 2) * m(2, 1) - m(0, 1) * m(2, 2),
                         m(0, 1) * m(1, 2) - m(0, 2) * m(1, 1)], dim=-1),
            torch.stack([c01,
                         m(0, 0) * m(2, 2) - m(0, 2) * m(2, 0),
                         m(0, 2) * m(1, 0) - m(0, 0) * m(1, 2)], dim=-1),
            torch.stack([c02,
                         m(0, 1) * m(2, 0) - m(0, 0) * m(2, 1),
                         m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0)], dim=-1),
        ],
        dim=-2,
    )
    inv3 = adj / det[..., None, None]
    t_inv = -torch.einsum("...ij,...j->...i", inv3, t)
    inv = torch.cat([inv3, t_inv[..., None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], device=mat.device
    ).expand(*inv.shape[:-2], 1, 4)
    return torch.cat([inv, bottom], dim=-2)


def get_camera(
    elevation_deg: Optional[ArrayLike] = None,
    distance: Optional[ArrayLike] = None,
    fovy_deg: Optional[ArrayLike] = None,
    azimuth_deg: Optional[ArrayLike] = None,
    num_views: Optional[int] = 1,
    c2w: Optional[torch.Tensor] = None,
    w2c: Optional[torch.Tensor] = None,
    proj_mtx: Optional[torch.Tensor] = None,
    aspect_wh: float = 1.0,
    near: float = 0.1,
    far: float = 100.0,
    perturb_camera_position: float = 0.0,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Camera:
    """Build a perspective Camera batch on ``device`` (the card unless
    ``device="cpu"``). The matrices are built on the host and then moved,
    so they have the same bits on every device (the card's ``cos``,
    ``sin``, ``tan``, norms and matrix products round otherwise).

    ``perturb_camera_position`` jitters camera positions by uniform noise
    in [-p, p], drawn on the CPU from ``generator`` (default: a generator
    seeded with 0). Its numbers differ from the JAX package's PRNG."""
    dev = resolve_device(device)
    host = torch.device("cpu")
    if w2c is None:
        if c2w is None:
            c2w = get_c2w(elevation_deg, distance, azimuth_deg, num_views, host)
        c2w = as_f32(c2w, host)
        if perturb_camera_position > 0.0:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            noise = torch.rand(c2w[:, :3, 3].shape, generator=generator)
            noise = (noise * 2.0 - 1.0) * perturb_camera_position
            c2w = c2w.clone()
            c2w[:, :3, 3] += noise
        cam_pos = c2w[:, :3, 3]
        # affine_inverse, not rigid_inverse: an external c2w may carry scale.
        w2c = affine_inverse(c2w)
    else:
        w2c = as_f32(w2c, host)
        cam_pos = None
        c2w = None
    if proj_mtx is None:
        proj_mtx = get_projection_matrix(
            fovy_deg, aspect_wh=aspect_wh, near=near, far=far, device=host
        )
    proj_mtx = as_f32(proj_mtx, host)
    if proj_mtx.shape[0] == 1 and w2c.shape[0] > 1:
        proj_mtx = proj_mtx.expand(w2c.shape[0], 4, 4)
    mvp_mtx = torch.matmul(proj_mtx, w2c)
    return Camera(c2w=c2w, w2c=w2c, proj_mtx=proj_mtx, mvp_mtx=mvp_mtx,
                  cam_pos=cam_pos).to(dev)


def get_orthogonal_camera(
    elevation_deg: ArrayLike,
    distance: ArrayLike,
    left: float,
    right: float,
    bottom: float,
    top: float,
    azimuth_deg: Optional[ArrayLike] = None,
    num_views: Optional[int] = 1,
    near: float = 0.1,
    far: float = 100.0,
    device: DeviceLike = None,
) -> Camera:
    """Build an orthographic Camera batch on ``device``, its matrices built
    on the host and then moved (see :func:`get_camera`)."""
    dev = resolve_device(device)
    c2w = get_c2w(elevation_deg, distance, azimuth_deg, num_views)
    w2c = rigid_inverse(c2w)
    proj_mtx = get_orthogonal_projection_matrix(
        c2w.shape[0], left, right, bottom, top, near=near, far=far
    )
    mvp_mtx = torch.matmul(proj_mtx, w2c)
    return Camera(c2w=c2w, w2c=w2c, proj_mtx=proj_mtx, mvp_mtx=mvp_mtx,
                  cam_pos=c2w[:, :3, 3]).to(dev)
