"""TexturedMesh, vertex normals, procedural meshes (PyTorch counterpart of
``worldrenderer_tpu/mesh.py``; host mesh IO and tangents come in a later
slice)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._device import DeviceLike
from .transforms import dot, fma_f32

__all__ = [
    "TexturedMesh",
    "compute_vertex_normals",
    "with_normals",
    "icosphere",
    "make_grid_mesh",
    "uv_sphere_mesh",
]


class TexturedMesh(NamedTuple):
    """v_pos (V, 3) float32; t_pos_idx (T, 3) int64. Optional UVs
    (v_tex, t_tex_idx), texture image (H, W, C), stitched topology for
    smooth normals, and per-vertex normals / tangents."""

    v_pos: torch.Tensor
    t_pos_idx: torch.Tensor
    v_tex: Optional[torch.Tensor] = None
    t_tex_idx: Optional[torch.Tensor] = None
    texture: Optional[torch.Tensor] = None
    stitched_v_pos: Optional[torch.Tensor] = None
    stitched_t_pos_idx: Optional[torch.Tensor] = None
    v_nrm: Optional[torch.Tensor] = None
    v_tang: Optional[torch.Tensor] = None

    @property
    def num_vertices(self) -> int:
        return self.v_pos.shape[0]

    @property
    def num_faces(self) -> int:
        return self.t_pos_idx.shape[0]

    def to(self, device: DeviceLike) -> "TexturedMesh":
        return TexturedMesh(*(None if a is None else a.to(device) for a in self))


def _sum_to_vertices(vals: torch.Tensor, t_pos_idx: torch.Tensor, n: int) -> torch.Tensor:
    """Per-face rows (T, C) summed onto the faces' three vertices -> (n, C).

    Each vertex's terms are added one at a time in the order of the
    corner list [corner 0 of every face, then corner 1, then corner 2]:
    the order of three ``index_add_`` calls on the CPU. On the card
    ``index_add_`` adds with atomics, in an order that changes from run to
    run; this fixed order gives the same bits on every device and run."""
    idx = t_pos_idx.T.reshape(-1)  # (3T,) corner-major
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    s_idx = idx[order]
    rank = torch.arange(idx.numel(), device=idx.device) - starts[s_idx]
    table = vals.new_zeros((n, int(counts.max()) if n else 0, vals.shape[1]))
    table[s_idx, rank] = vals.repeat(3, 1)[order]
    out = vals.new_zeros((n, vals.shape[1]))
    for k in range(table.shape[1]):
        out += table[:, k]  # adding a padding zero leaves a sum unchanged
    return out


def compute_vertex_normals(v_pos: torch.Tensor, t_pos_idx: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals: face normals summed onto their three
    vertices in a fixed order (the JAX package's segment sum)."""
    i0, i1, i2 = t_pos_idx[:, 0], t_pos_idx[:, 1], t_pos_idx[:, 2]
    v0, v1, v2 = v_pos[i0], v_pos[i1], v_pos[i2]
    face_normals = torch.linalg.cross(v1 - v0, v2 - v0)  # (T, 3)
    v_nrm = _sum_to_vertices(face_normals, t_pos_idx, v_pos.shape[0])
    up = torch.tensor([0.0, 0.0, 1.0], dtype=v_nrm.dtype, device=v_nrm.device)
    v_nrm = torch.where(dot(v_nrm, v_nrm) > 1e-20, v_nrm, up)
    return _normalize_rows(v_nrm)


def _normalize_rows(v: torch.Tensor) -> torch.Tensor:
    """``normalize`` of (N, 3) fp32 rows with the same bits on every device.

    ``linalg.vector_norm`` of such rows rounds differently on the CPU and
    on the card. Here the squared norm is the fp32 chain
    fma(x2, x2, fma(x1, x1, x0 * x0)) — the bits of ``normalize`` on the
    CPU and of the JAX package's ``normalize`` — and the root and the
    quotient are taken in float64 and rounded once, which gives the
    correctly rounded fp32 result (53 >= 2 * 24 + 2)."""
    v64 = v.double()
    ss = (v64[:, 0] * v64[:, 0]).float().double()
    ss = fma_f32(v64[:, 1], v64[:, 1], ss).double()
    ss = fma_f32(v64[:, 2], v64[:, 2], ss).double()
    norm = torch.sqrt(ss).float().double()
    return (v64 / torch.clamp(norm, min=1e-12)[:, None]).float()


def with_normals(mesh: TexturedMesh, compute_tangents: bool = False) -> TexturedMesh:
    """The mesh with v_nrm filled in, computed on the stitched topology."""
    if compute_tangents:
        raise NotImplementedError(
            "vertex tangents come with textures (ROADMAP queue 1 item 5)"
        )
    if mesh.stitched_v_pos is None or mesh.stitched_t_pos_idx is None:
        mesh = mesh._replace(
            stitched_v_pos=mesh.v_pos, stitched_t_pos_idx=mesh.t_pos_idx
        )
    if mesh.v_nrm is None:
        mesh = mesh._replace(
            v_nrm=compute_vertex_normals(
                mesh.stitched_v_pos, mesh.stitched_t_pos_idx
            )
        )
    return mesh


# ---------------------------------------------------------------------------
# Procedural meshes (numpy, host side): test fixtures and benchmarks.
# ---------------------------------------------------------------------------


def icosphere(subdivisions: int = 2, radius: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere. Returns (vertices, faces)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m = m / np.linalg.norm(m)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(verts_list)
        faces = np.array(new_faces, dtype=np.int64)

    return verts * radius, faces


def make_grid_mesh(
    n: int, extent: float = 1.0, height_fn=None
) -> Tuple[np.ndarray, np.ndarray]:
    """(n x n)-vertex heightfield grid mesh in the XY plane.
    height_fn(x, y) -> z, default 0."""
    xs = np.linspace(-extent, extent, n)
    ys = np.linspace(-extent, extent, n)
    xx, yy = np.meshgrid(xs, ys, indexing="xy")
    zz = np.zeros_like(xx) if height_fn is None else height_fn(xx, yy)
    verts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    idx = np.arange(n * n).reshape(n, n)
    f0 = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1]], axis=-1)
    f1 = np.stack([idx[:-1, 1:], idx[1:, 1:], idx[1:, :-1]], axis=-1)
    faces = np.concatenate([f0.reshape(-1, 3), f1.reshape(-1, 3)], axis=0)
    return verts, faces.astype(np.int64)


def uv_sphere_mesh(
    n_lat: int, n_lon: int, radius: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """UV-parameterized sphere: (vertices, faces, uv), wound so
    cross(v1-v0, v2-v0) points outward."""
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
