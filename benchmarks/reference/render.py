"""The plain reference of a ``render_chunk`` request: the frames that
``project_and_render``'s ``render_batch`` hands to its writers (textured
rgb, 16-bit-scale depth, normal and the textured mask), from the shared
inputs alone (mesh arrays, texture, camera matrices), in float64 (or, as a
witness of rounding alone, in float32: ``dtype``).

Semantics: vertex normals area-weighted and normalized, interpolated and
normalized per pixel (0 on the background); (u, v) interpolated and the
texture sampled bilinearly at x = u W - 1/2, y = v H - 1/2 with wrapping
indices (row 0 at v = 0); colour ``attr_background`` off the mesh, then 0
wherever the colour's channels sum to at most 1e-6; depth the view-space
distance -z_cam scaled by ``depth_scale`` and clamped to [0, 1], 1 off the
mesh.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import raster


def sample_wrap(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (H, W, C) ``tex`` at (P, 2) ``uv``, wrapping, in
    ``uv``'s dtype."""
    th, tw = tex.shape[:2]
    t = tex.to(uv.dtype)
    x = uv[:, 0] * tw - 0.5
    y = uv[:, 1] * th - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi, yi = x0.long(), y0.long()

    def tap(dy, dx):
        return t[(yi + dy) % th, (xi + dx) % tw]

    return ((tap(0, 0) * (1 - fx) + tap(0, 1) * fx) * (1 - fy)
            + (tap(1, 0) * (1 - fx) + tap(1, 1) * fx) * fy)


def render_frames(scene: Dict, cams: Dict, height: int, width: int,
                  depth_scale: float, attr_background: float, cull: int = 0,
                  tf32: bool = False,
                  dtype: torch.dtype = torch.float64) -> Dict[str, torch.Tensor]:
    """scene: v_pos (N, 3), tri (T, 3), v_tex (N, 2), texture (Ht, Wt, 3)
    on one device; cams: mvp, w2c (V, 4, 4). Returns rgb (V, H, W, 3),
    depth (V, H, W), normal (V, H, W, 3) float32 and mask (V, H, W) bool,
    one view at a time, computed in ``dtype``."""
    v_pos, tri = scene["v_pos"], scene["tri"]
    nrm_v = raster.vertex_normals(v_pos, tri, dtype)
    n_views = cams["mvp"].shape[0]
    dev = v_pos.device
    out = {"rgb": torch.zeros((n_views, height, width, 3), device=dev),
           "depth": torch.ones((n_views, height, width), device=dev),
           "normal": torch.zeros((n_views, height, width, 3), device=dev),
           "mask": torch.zeros((n_views, height, width), dtype=torch.bool,
                               device=dev)}
    for v in range(n_views):
        clip = raster.clip_positions(v_pos, cams["mvp"][v:v + 1], tf32,
                                     dtype)[0]
        tid = raster.rasterize(clip, tri, height, width, cull).tri_id
        bary, pix = raster.barycentrics(clip, tri, tid, height, width)
        pos = raster.interpolate(v_pos, tri, tid, bary, pix)
        nrm = raster.normalize(raster.interpolate(nrm_v, tri, tid, bary, pix))
        uv = raster.interpolate(scene["v_tex"], tri, tid, bary, pix)
        rgb = sample_wrap(scene["texture"], uv)
        w2c = cams["w2c"][v].to(dtype)
        depth = -(pos @ w2c[2, :3] + w2c[2, 3])
        depth = torch.clamp(depth * depth_scale, 0.0, 1.0)
        flat_rgb = out["rgb"].view(n_views, -1, 3)[v]
        flat_rgb[:] = attr_background
        flat_rgb[pix] = rgb.float()
        tex_mask = torch.zeros(height * width, dtype=torch.bool, device=dev)
        tex_mask[pix] = True
        tex_mask &= flat_rgb.abs().sum(-1) > 1e-6
        flat_rgb[~tex_mask] = 0.0
        out["mask"][v] = tex_mask.view(height, width)
        out["depth"].view(n_views, -1)[v][pix] = depth.float()
        out["normal"].view(n_views, -1, 3)[v][pix] = nrm.float()
    return out


def textured_views(scene: Dict, texture: torch.Tensor, cams: Dict, height: int,
                   width: int, background: float) -> torch.Tensor:
    """(V, H, W, 3) float32 views of the mesh wearing ``texture``: the
    texture sampled at each covered pixel's (u, v), ``background``
    elsewhere. The benchmark makes bake requests' view images with it."""
    v_pos, tri = scene["v_pos"], scene["tri"]
    n_views = cams["mvp"].shape[0]
    out = torch.full((n_views, height * width, 3), background,
                     device=v_pos.device)
    for v in range(n_views):
        clip = raster.clip_positions(v_pos, cams["mvp"][v:v + 1])[0]
        tid = raster.rasterize(clip, tri, height, width).tri_id
        bary, pix = raster.barycentrics(clip, tri, tid, height, width)
        uv = raster.interpolate(scene["v_tex"], tri, tid, bary, pix)
        out[v, pix] = sample_wrap(texture, uv).float()
    return out.view(n_views, height, width, 3)
