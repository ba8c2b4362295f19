"""Scene, camera and image generators of the benchmark: its own frozen
copies, so that a change to the program cannot move the yardstick.

* ``grid_mesh`` is ``worldrenderer_tpu_torch.mesh.make_grid_mesh`` (the
  heightfield of ``bench.py:298``) with planar UVs added;
* ``uv_sphere`` is ``worldrenderer_tpu_torch.mesh.uv_sphere_mesh``;
* ``look_at_c2w``, ``perspective`` and ``orthographic`` follow the port's
  ``camera.get_c2w`` / ``get_projection_matrix`` /
  ``get_orthogonal_projection_matrix`` conventions (Z up, columns [right,
  up, -lookat], a negated Y row), built in float64 on the host and rounded
  once to float32.

Every camera matrix and every mesh array is made here and handed to both
the program and the plain reference, so they read the same inputs.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def grid_mesh(n: int, extent: float, amp: float, freq: float):
    """(n x n)-vertex heightfield z = amp sin(freq x) cos(freq y) over
    [-extent, extent]^2: vertices (n^2, 3), faces (2 (n-1)^2, 3) and
    planar UVs u = (x + extent) / (2 extent), v likewise."""
    xs = np.linspace(-extent, extent, n)
    xx, yy = np.meshgrid(xs, xs, indexing="xy")
    zz = amp * np.sin(freq * xx) * np.cos(freq * yy)
    verts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    idx = np.arange(n * n).reshape(n, n)
    f0 = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1]], axis=-1)
    f1 = np.stack([idx[:-1, 1:], idx[1:, 1:], idx[1:, :-1]], axis=-1)
    faces = np.concatenate([f0.reshape(-1, 3), f1.reshape(-1, 3)], axis=0)
    uv = (verts[:, :2] + extent) / (2.0 * extent)
    return verts, faces.astype(np.int64), uv


def uv_sphere(n_lat: int, n_lon: int, radius: float):
    """UV-parameterized sphere: (vertices, faces, uv), wound so that
    cross(v1 - v0, v2 - v0) points outward; u = longitude / 2 pi, v =
    colatitude / pi. The poles' rows hold zero-area triangles."""
    lats = np.linspace(0, np.pi, n_lat)
    lons = np.linspace(0, 2 * np.pi, n_lon)
    ll, tt = np.meshgrid(lons, lats, indexing="xy")
    x = radius * np.sin(tt) * np.cos(ll)
    y = radius * np.sin(tt) * np.sin(ll)
    z = radius * np.cos(tt)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    uv = np.stack([ll / (2 * np.pi), tt / np.pi], axis=-1).reshape(-1, 2)
    idx = np.arange(n_lat * n_lon).reshape(n_lat, n_lon)
    f0 = np.stack([idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:]], axis=-1)
    f1 = np.stack([idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]], axis=-1)
    faces = np.concatenate([f0.reshape(-1, 3), f1.reshape(-1, 3)], axis=0)
    return verts, faces.astype(np.int64), uv


def make_scene(spec: Dict):
    """The configuration's ``scene`` entry as (vertices, faces, uv)."""
    kind = spec["kind"]
    if kind == "heightfield":
        return grid_mesh(spec["grid_n"], spec["extent"], spec["height_amp"],
                         spec["height_freq"])
    if kind == "uv_sphere":
        return uv_sphere(spec["n_lat"], spec["n_lon"], spec["radius"])
    raise ValueError(f"unknown scene kind {kind!r}")


def look_at_c2w(elev_deg, azim_deg, dist) -> np.ndarray:
    """(N, 4, 4) float64 orbit camera-to-world matrices looking at the
    origin, Z up, columns [right, up, -lookat, position]."""
    elev = np.radians(np.asarray(elev_deg, np.float64))
    azim = np.radians(np.asarray(azim_deg, np.float64))
    dist = np.broadcast_to(np.asarray(dist, np.float64), elev.shape)
    pos = np.stack([dist * np.cos(elev) * np.cos(azim),
                    dist * np.cos(elev) * np.sin(azim),
                    dist * np.sin(elev)], axis=-1)
    lookat = -pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    up_world = np.array([0.0, 0.0, 1.0])
    right = np.cross(lookat, up_world)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    up = np.cross(right, lookat)
    up /= np.linalg.norm(up, axis=-1, keepdims=True)
    c2w = np.zeros(pos.shape[:-1] + (4, 4))
    c2w[..., :3, 0], c2w[..., :3, 1], c2w[..., :3, 2] = right, up, -lookat
    c2w[..., :3, 3] = pos
    c2w[..., 3, 3] = 1.0
    return c2w


def perspective(n: int, fovy_deg: float, near: float, far: float,
                aspect_wh: float = 1.0) -> np.ndarray:
    t = math.tan(math.radians(fovy_deg) / 2.0)
    p = np.zeros((n, 4, 4))
    p[:, 0, 0] = 1.0 / (aspect_wh * t)
    p[:, 1, 1] = -1.0 / t
    p[:, 2, 2] = -(far + near) / (far - near)
    p[:, 2, 3] = -2.0 * far * near / (far - near)
    p[:, 3, 2] = -1.0
    return p


def orthographic(n: int, half: float, near: float, far: float) -> np.ndarray:
    p = np.zeros((n, 4, 4))
    p[:, 0, 0] = 1.0 / half
    p[:, 1, 1] = -1.0 / half
    p[:, 2, 2] = -2.0 / (far - near)
    p[:, 2, 3] = -(far + near) / (far - near)
    p[:, 3, 3] = 1.0
    return p


def camera_arrays(c2w: np.ndarray, proj: np.ndarray) -> Dict[str, np.ndarray]:
    """float32 c2w, w2c, proj, mvp (each (N, 4, 4)) and cam_pos (N, 3):
    the inverse and the product taken in float64, each rounded once."""
    w2c = np.linalg.inv(c2w)
    mvp = proj @ w2c
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    return {"c2w": f32(c2w), "w2c": f32(w2c), "proj": f32(proj),
            "mvp": f32(mvp), "cam_pos": f32(c2w[:, :3, 3])}


def path_cameras(spec: Dict, height: int, width: int) -> Dict[str, np.ndarray]:
    """A smooth camera path of ``frames`` frames: azimuth from
    ``azimuth_start_deg`` in steps of ``azimuth_step_deg``, elevation
    ``elevation_deg[0] + elevation_deg[1] sin(2 pi t / frames)``, distance
    ``distance[0] + distance[1] cos(2 pi t / frames)``; perspective at
    ``fovy_deg``. Every seed sees the same path."""
    n = spec["frames"]
    t = np.arange(n, dtype=np.float64)
    ph = 2.0 * np.pi * t / n
    elev = spec["elevation_deg"][0] + spec["elevation_deg"][1] * np.sin(ph)
    dist = spec["distance"][0] + spec["distance"][1] * np.cos(ph)
    azim = spec["azimuth_start_deg"] + spec["azimuth_step_deg"] * t
    c2w = look_at_c2w(elev, azim, dist)
    proj = perspective(n, spec["fovy_deg"], spec["near"], spec["far"],
                       width / height)
    return camera_arrays(c2w, proj)


def rig_cameras(spec: Dict) -> Dict[str, np.ndarray]:
    """The MV-Adapter six-view orthographic rig: views at the listed
    elevations and azimuths (each azimuth less 90 degrees, -y as front, as
    ``TexturePipeline`` builds it), ``distance`` from the origin, an
    orthographic box of ``ortho_scale`` across."""
    elev = np.asarray(spec["elevation_deg"], np.float64)
    azim = np.asarray(spec["azimuth_deg"], np.float64) - 90.0
    c2w = look_at_c2w(elev, azim, spec["distance"])
    proj = orthographic(len(elev), spec["ortho_scale"] / 2.0, spec["near"],
                        spec["far"])
    return camera_arrays(c2w, proj)


def request_cameras(spec: Dict, height: int, width: int) -> Dict[str, np.ndarray]:
    """The traffic mix's ``cameras`` entry: a path (every ``every``-th
    frame of it) or the orthographic rig."""
    if spec["kind"] == "path":
        cams = path_cameras(spec, height, width)
        every = spec.get("every", 1)
        return {k: v[::every] for k, v in cams.items()}
    if spec["kind"] == "ortho_rig":
        return rig_cameras(spec)
    raise ValueError(f"unknown cameras kind {spec['kind']!r}")


def smooth_noise(gen: torch.Generator, shape: Tuple[int, ...], cell: int,
                 low: float, high: float, device) -> torch.Tensor:
    """(N, H, W, C) float32 smooth noise in [low, high]: uniform draws on a
    grid ``cell`` times coarser, bilinearly enlarged, made on ``device``
    from ``gen`` in one draw."""
    n, h, w, c = shape
    coarse = torch.rand((n, c, -(-h // cell) + 1, -(-w // cell) + 1),
                        generator=gen, device=device)
    big = F.interpolate(coarse, scale_factor=cell, mode="bilinear",
                        align_corners=False)[:, :, :h, :w]
    return (low + (high - low) * big).permute(0, 2, 3, 1).contiguous()
