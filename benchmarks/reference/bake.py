"""The plain reference of a bake request: ``camera_projection`` of view
images into a UV texture with the keywords that ``TexturePipeline`` gives
its rgb modality, from the shared inputs alone (mesh arrays, the mesh's
texture, camera matrices, images), in float64 (or, as a witness of
rounding alone, in float32: ``dtype``).

Semantics, stage by stage:

* atlas: the UV triangles rasterized at (2u - 1, 2v - 1) over the
  uv_size^2 texel grid, no cull; each covered texel's world position
  interpolated over the position triangles;
* views: each view rendered (no cull): its mask, world position (0 off
  the mesh) and the angle-of-incidence cosine, the z of the interpolated
  and normalized vertex normal rotated into the camera, clamped to [0, 1]
  (0 off the mesh);
* gather: each texel's position projected into every view and the view's
  position, cosine and image sampled there bilinearly
  (``align_corners=False``, zeros outside);
* validity: |sampled position - texel position| < ``pos_error_eps``,
  cosine > ``aoi_cos_valid_threshold``, inside the atlas;
* blend: weights (cosine * valid) ** (alpha / view_weight), divided by
  their sum over views clamped below at 1e-5, clamped to [0, 1]; the
  images' weighted sum where any view is valid, the mesh's texture
  elsewhere;
* gutter padding: the result clamped to [0, 1], then 3 steps in which
  each unknown texel with a known 4-neighbour takes their mean and becomes
  known; known are the valid texels (``from_scratch``) or the atlas.

Only the keywords of the benchmark's configurations are modelled; others
are refused.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import raster

PADDING_RADIUS = 3


def _check_keywords(kw: Dict) -> None:
    fixed = {"poisson_blending": False, "depth_grad_threshold": None,
             "iou_rejection_threshold": None}
    for k, v in fixed.items():
        if kw.get(k, v) != v:
            raise ValueError(f"the reference models {k}={v!r} only")


def atlas(scene: Dict, uv_size: int, dtype: torch.dtype = torch.float64):
    """(uv_mask (S, S) bool, uv_pos (S, S, 3) ``dtype``)."""
    v_tex = scene["v_tex"].to(dtype)
    clip = torch.cat([v_tex * 2.0 - 1.0, torch.zeros_like(v_tex[:, :1]),
                      torch.ones_like(v_tex[:, :1])], dim=1)
    tid = raster.rasterize(clip, scene["t_tex"], uv_size, uv_size, 0).tri_id
    bary, pix = raster.barycentrics(clip, scene["t_tex"], tid, uv_size, uv_size)
    # Barycentrics of the texel's UV triangle weigh that face's position
    # corners.
    t = tid.reshape(-1)[pix]
    corners = scene["v_pos"].to(dtype)[scene["tri"][t]]
    pos = torch.zeros((uv_size * uv_size, 3), dtype=dtype,
                      device=v_tex.device)
    pos[pix] = (bary[..., None] * corners).sum(dim=1)
    return tid >= 0, pos.view(uv_size, uv_size, 3)


def view_maps(scene: Dict, cams: Dict, height: int, width: int, tf32: bool,
              dtype: torch.dtype = torch.float64):
    """Per view: (pos (V, H, W, 3), aoi (V, H, W)) ``dtype``."""
    v_pos, tri = scene["v_pos"], scene["tri"]
    nrm_v = raster.vertex_normals(v_pos, tri, dtype)
    n_views = cams["mvp"].shape[0]
    dev = v_pos.device
    pos = torch.zeros((n_views, height * width, 3), dtype=dtype, device=dev)
    aoi = torch.zeros((n_views, height * width), dtype=dtype, device=dev)
    for v in range(n_views):
        clip = raster.clip_positions(v_pos, cams["mvp"][v:v + 1], tf32,
                                     dtype)[0]
        tid = raster.rasterize(clip, tri, height, width, 0).tri_id
        bary, pix = raster.barycentrics(clip, tri, tid, height, width)
        pos[v, pix] = raster.interpolate(v_pos, tri, tid, bary, pix)
        nrm = raster.normalize(raster.interpolate(nrm_v, tri, tid, bary, pix))
        rot = cams["w2c"][v, :3, :3].to(dtype)
        ncs = raster.normalize(nrm @ rot.T)
        aoi[v, pix] = ncs[:, 2].clamp(0.0, 1.0)
    return pos.view(n_views, height, width, 3), aoi.view(n_views, height, width)


def bake(scene: Dict, cams: Dict, images: torch.Tensor, uv_size: int,
         kw: Dict, tf32: bool = False, dtype: torch.dtype = torch.float64):
    """images (V, H, W, C); scene also holds t_tex (T, 3) and texture
    (S, S, C). Returns (uv_proj (S, S, C) float32, uv_proj_mask (S, S)
    bool), computed in ``dtype``. The texel gather runs in blocks of rows
    of about 2^24 samples."""
    _check_keywords(kw)
    n_views, height, width, n_ch = images.shape
    uv_mask, uv_pos = atlas(scene, uv_size, dtype)
    vpos, vaoi = view_maps(scene, cams, height, width, tf32, dtype)
    # (V, C', H, W) planes sampled together: position, cosine, image.
    planes = torch.cat([vpos, vaoi[..., None], images.to(dtype)], dim=-1)
    planes = planes.permute(0, 3, 1, 2).contiguous()
    eps = float(kw.get("pos_error_eps", 1e-3))
    aoi_t = float(kw.get("aoi_cos_valid_threshold", 0.3))
    alpha = float(kw.get("uv_exp_blend_alpha", 6))
    vw = kw.get("uv_exp_blend_view_weight")
    expo = torch.full((n_views,), alpha, dtype=dtype, device=images.device)
    if vw is not None:
        expo = expo / torch.as_tensor(vw, dtype=dtype, device=images.device)
    mvp = cams["mvp"]
    blend = torch.zeros((uv_size, uv_size, n_ch), dtype=dtype,
                        device=images.device)
    any_valid = torch.zeros((uv_size, uv_size), dtype=torch.bool,
                            device=images.device)
    texel_rows = max(1, (1 << 24) // (n_views * uv_size))
    for r0 in range(0, uv_size, texel_rows):
        p = uv_pos[r0:r0 + texel_rows]  # (R, S, 3)
        rows = p.shape[0]
        if tf32:  # the program's texel positions are float32
            clip = raster.clip_positions(p.reshape(-1, 3).float(), mvp, True,
                                         dtype)
        else:
            clip = _clip(p.reshape(-1, 3), mvp)
        ndc = (clip[..., :2] / clip[..., 3:4]).view(n_views, rows, uv_size, 2)
        s = F.grid_sample(planes, ndc, mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # (V, C', R, S)
        s = s.permute(0, 2, 3, 1)
        err = (s[..., :3] - p[None]).norm(dim=-1)
        cosv = s[..., 3]
        valid = (err < eps) & (cosv > aoi_t) & uv_mask[None, r0:r0 + rows]
        weight = (cosv * valid) ** expo[:, None, None]
        total = weight.sum(0).clamp(min=1e-5)
        wn = (weight / total).clamp(0.0, 1.0)
        blend[r0:r0 + rows] = (s[..., 4:] * wn[..., None]).sum(0)
        any_valid[r0:r0 + rows] = valid.any(0)
    tex = scene["texture"].to(dtype)
    out = torch.where(any_valid[..., None], blend, tex)
    if kw.get("uv_padding", True):
        known = any_valid if kw.get("from_scratch", False) else uv_mask
        out = inpaint(out.clamp(0.0, 1.0), known, PADDING_RADIUS)
    return out.float(), any_valid


def _clip(p: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
    ph = torch.cat([p, torch.ones_like(p[:, :1])], dim=1)
    return torch.einsum("vij,nj->vni", mvp.to(p.dtype), ph)


def inpaint(img: torch.Tensor, known: torch.Tensor, radius: int) -> torch.Tensor:
    """(S, S, C) ``img``: ``radius`` steps in which every unknown texel
    with a known 4-neighbour takes their mean and becomes known."""
    x = img.permute(2, 0, 1)[None]
    k = known.to(x.dtype)[None, None]
    kern = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 1.0], [0.0, 1.0, 0.0]],
                        dtype=x.dtype, device=x.device)[None, None]
    for _ in range(radius):
        c = x.shape[1]
        nb_sum = F.conv2d(F.pad(x * k, (1, 1, 1, 1)),
                          kern.expand(c, 1, 3, 3), groups=c)
        nb_cnt = F.conv2d(F.pad(k, (1, 1, 1, 1)), kern)
        newly = (k == 0) & (nb_cnt > 0)
        x = torch.where(newly, nb_sum / nb_cnt.clamp(min=1.0), x)
        k = torch.where(newly, torch.ones_like(k), k)
    return x[0].permute(1, 2, 0)
