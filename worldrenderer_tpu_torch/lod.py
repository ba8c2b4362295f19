"""Level-of-detail chains (PyTorch port of ``worldrenderer_tpu/lod.py``).

Forward rasterization pays per (binned triangle, tile pixel), so a
million-triangle mesh at 512² floods every tile with sub-pixel triangles.
A QEM decimation chain, built on the host at load time by the native
meshproc library, answers that per view: the level is chosen from the
projected screen coverage so that rendered triangles stay above a target
pixel area. Each level is a different shape, so the choice is made on the
host, before the render.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .mesh import TexturedMesh

__all__ = ["LODChain", "build_lod_chain", "select_lod_level"]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class LODChain:
    """Decimation pyramid over a base mesh. levels[0] is the full-detail
    mesh; levels[i] targets ``num_faces / factors[i]`` faces. ``bbox`` is
    the base mesh's bbox on the host, kept so that :meth:`select` never
    reads the vertices back from the card."""

    def __init__(
        self,
        levels: List[TexturedMesh],
        factors: Sequence[int],
        bbox: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ):
        self.levels = levels
        self.factors = tuple(factors)
        if bbox is None:
            v = _host(levels[0].v_pos)
            bbox = (v.min(0), v.max(0))
        self.bbox = bbox

    def __len__(self) -> int:
        return len(self.levels)

    def select(
        self,
        cam,
        height: int,
        width: int,
        target_px_per_tri: float = 2.0,
    ) -> int:
        """The finest level whose expected screen area per triangle stays
        at least ``target_px_per_tri`` (see :func:`select_lod_level`)."""
        return select_lod_level(
            self, cam, height, width, target_px_per_tri=target_px_per_tri
        )

    def mesh_for(self, cam, height: int, width: int,
                 device: DeviceLike = None, **kw) -> TexturedMesh:
        """The selected level on ``device`` (the card unless
        ``device="cpu"``)."""
        level = self.levels[self.select(cam, height, width, **kw)]
        return level.to(resolve_device(device))


def _unify_uv_topology(
    v_pos: np.ndarray, pos_idx: np.ndarray, v_tex: np.ndarray,
    tex_idx: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seam-cut unified indexing: one vertex per unique (pos_idx, tex_idx)
    corner pair (what ``decimate_with_texture`` expects)."""
    pos_idx = pos_idx.reshape(-1)
    tex_idx = tex_idx.reshape(-1)
    key = pos_idx.astype(np.int64) << 32 | tex_idx.astype(np.int64)
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    return (v_pos[pos_idx[first]], v_tex[tex_idx[first]],
            inverse.reshape(-1, 3))


def build_lod_chain(
    mesh: TexturedMesh,
    factors: Sequence[int] = (1, 4, 16, 64),
    min_faces: int = 512,
    device: DeviceLike = None,
) -> LODChain:
    """Precompute a QEM decimation chain on the host; its levels lie on
    ``device`` (the card unless ``device="cpu"``).

    ``factors``: face-count divisors per level relative to the base mesh;
    factor 1 is the base mesh itself. Levels whose target would fall below
    ``min_faces`` are dropped. A textured mesh decimates through the 5D
    (position + UV) quadrics with seam constraints
    (``meshproc.decimate_with_texture``), so every level keeps a usable
    atlas. The base geometry is read to the host once; each level is
    decimated from the previous one (deep levels cost what their parent
    costs, not what the base does), converted to float32 / int64 on the
    host and then moved."""
    from . import meshproc

    dev = resolve_device(device)
    t_total = int(mesh.num_faces)
    textured = mesh.v_tex is not None and mesh.t_tex_idx is not None
    levels: List[TexturedMesh] = [mesh.to(dev)]
    used: List[int] = [1]
    if textured:
        prev_pos, prev_tex, prev_faces = _unify_uv_topology(
            _host(mesh.v_pos), _host(mesh.t_pos_idx), _host(mesh.v_tex),
            _host(mesh.t_tex_idx))
    else:
        prev_pos = _host(mesh.v_pos).astype(np.float64)
        prev_tex = None
        prev_faces = _host(mesh.t_pos_idx).astype(np.int64)
    bbox = (prev_pos.min(0), prev_pos.max(0))
    texture = None if mesh.texture is None else mesh.texture.to(dev)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def i64(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    for f in sorted(set(factors)):
        if f <= 1:
            continue
        target = t_total // f
        if target < min_faces:
            break
        if textured:
            prev_pos, prev_tex, prev_faces = meshproc.decimate_with_texture(
                prev_pos, prev_tex, prev_faces, target_faces=target
            )
            faces = i64(prev_faces)
            levels.append(TexturedMesh(
                v_pos=f32(prev_pos), t_pos_idx=faces, v_tex=f32(prev_tex),
                t_tex_idx=faces, texture=texture,
            ))
        else:
            prev_pos, prev_faces = meshproc.decimate(
                prev_pos, prev_faces, target_faces=target
            )
            levels.append(TexturedMesh(v_pos=f32(prev_pos),
                                       t_pos_idx=i64(prev_faces)))
        used.append(f)
    return LODChain(levels, used, bbox=bbox)


def _screen_area_estimate(bbox, cam, height: int, width: int):
    """Expected covered pixels per view: the mesh bbox's corners projected,
    half the clipped 2D-bbox area (0.5 for a roundish object inside its
    bbox). (n_views,) numpy, computed on the host in float32."""
    lo, hi = bbox
    corners = np.array(
        [[x, y, z, 1.0] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
         for z in (lo[2], hi[2])],
        np.float32,
    )  # (8, 4)
    mvp = _host(cam.mvp_mtx)  # (B, 4, 4)
    clip = np.einsum("bij,cj->bci", mvp, corners)
    w = np.maximum(clip[..., 3], 1e-6)
    x = (clip[..., 0] / w * 0.5 + 0.5) * width
    y = (clip[..., 1] / w * 0.5 + 0.5) * height
    x = np.clip(x, 0, width)
    y = np.clip(y, 0, height)
    return 0.5 * np.maximum(x.max(1) - x.min(1), 0.0) * np.maximum(
        y.max(1) - y.min(1), 0.0
    )


def select_lod_level(
    chain: LODChain,
    cam,
    height: int,
    width: int,
    target_px_per_tri: float = 2.0,
) -> int:
    """The finest level (lowest index) whose expected pixels per triangle
    meet the target, at the worst view of the batch (one level per batched
    render). The coarsest level when even it is denser than the target."""
    area = float(np.max(_screen_area_estimate(chain.bbox, cam, height, width)))
    for li, mesh in enumerate(chain.levels):
        if area / max(int(mesh.num_faces), 1) >= target_px_per_tri:
            return li
    return len(chain.levels) - 1
