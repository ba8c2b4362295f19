"""Texel-sharded UV baking: ``camera_projection`` over a device mesh
(PyTorch counterpart of ``worldrenderer_tpu/parallel/bake.py``).

The bake's per-texel stages are row-local in the UV image: each texel's
gathers, validity tests and blend weights depend on that texel alone. So
the texel rows split into one band per device of the mesh axis, and each
band into ``texel_chunks`` sequential chunks, which divides the memory of
the (Nv, rows, Wuv, ~12) per-view texel maps by the band and chunk count
(about 5 GB at 6 views and 4096² in one piece). Per distinct device:

* ``uv_precompute`` (the UV atlas) and ``uv_view_geometry`` (the views'
  G-buffers, normals and depth gradients) run once, hoisted out of the
  chunk loop, and the "auto" validity bounds resolve from that view
  render;
* ``uv_gather_geometry`` -> ``uv_render_attr`` -> ``uv_blend_sum`` run per
  band and chunk.

The bands are stitched on the mesh's first device, where ``uv_blend_post``
(gutter padding, Poisson) runs on the whole image. The per-texel ops are
the unsharded bake's on fewer rows, so on one device the sharded bake
equals ``camera_projection`` bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..baking.projection import (
    _AUTO_DEPTH_GRAD_FOOTPRINTS,
    _AUTO_POS_EPS_FOOTPRINTS,
    CameraProjectionOutput,
    _auto_footprint,
    _auto_pack_mode,
    _check_validity_bound,
    _validate_binning_budgets,
)
from ..baking.uv import (
    ExponentialBlend,
    SimpleUVValidityStrategy,
    UVPrecomputeOutput,
    uv_blend_post,
    uv_blend_sum,
    uv_gather_geometry,
    uv_precompute,
    uv_render_attr,
    uv_view_geometry,
)
from ..camera import Camera, get_camera
from ..mesh import TexturedMesh
from ..ops.rasterize import DEFAULT_CONFIG, RasterizerConfig
from ..render import render
from .device_mesh import DeviceMesh, make_device_mesh

__all__ = ["sharded_camera_projection"]


def _rows(pre: UVPrecomputeOutput, rows: slice) -> UVPrecomputeOutput:
    uv_pos = pre.uv_pos[rows]
    return UVPrecomputeOutput(height=uv_pos.shape[0], width=uv_pos.shape[1],
                              uv_attr=pre.uv_attr[rows], uv_mask=pre.uv_mask[rows],
                              uv_pos=uv_pos)


def sharded_camera_projection(
    images,
    mesh: TexturedMesh,
    cam: Optional[Camera] = None,
    device_mesh: Optional[DeviceMesh] = None,
    axis_name: str = "uv",
    masks=None,
    fovy_deg=None,
    c2w=None,
    elevation_deg=None,
    distance=None,
    azimuth_deg=None,
    num_views: Optional[int] = None,
    uv_size: int = 2048,
    iou_rejection_threshold: Optional[float] = 0.8,
    aoi_cos_valid_threshold: float = 0.3,
    pos_error_eps=1e-3,
    depth_grad_dilation: int = 5,
    depth_grad_threshold=0.1,
    uv_exp_blend_alpha: float = 6,
    uv_exp_blend_view_weight=None,
    poisson_blending: bool = True,
    pb_num_iters: int = 1000,
    pb_keep_original_border: bool = True,
    from_scratch: bool = False,
    uv_padding: bool = True,
    raster_config: RasterizerConfig = DEFAULT_CONFIG,
    verbose: bool = False,
    validate_binning: bool = True,
    images_pack_mode: str = "auto",
    texel_chunks: int = 1,
) -> Optional[CameraProjectionOutput]:
    """``baking.camera_projection`` with the UV texel rows split over the
    mesh axis ``axis_name`` of ``device_mesh`` (default: a 1-D mesh over
    every local CUDA device), each band further in ``texel_chunks``
    sequential chunks. ``uv_size`` must divide by the axis size times
    ``texel_chunks``. The outputs are stitched on the mesh's first device
    (the JAX package leaves them row-sharded over its mesh).

    The IoU rejection is decided on the host before the bake, from a
    silhouette render; ``warp_images`` and ``bg_remover`` are not taken
    (run ``compute_warp_field`` or the remover on the views first: both are
    view-space)."""
    if device_mesh is None:
        device_mesh = make_device_mesh(axis_names=(axis_name,))
    n_shards = device_mesh.shape[axis_name]
    if texel_chunks < 1 or uv_size % (n_shards * texel_chunks) != 0:
        raise ValueError(
            f"uv_size {uv_size} must divide by mesh axis '{axis_name}' size "
            f"{n_shards} x texel_chunks {texel_chunks}")
    band_devices = device_mesh.along(axis_name)
    dev0 = band_devices[0]

    if images_pack_mode == "auto":
        images_pack_mode = _auto_pack_mode(images)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev0)
    if images.ndim != 4:
        raise ValueError("images must be (Nv, H, W, C)")
    _, height, width, n_ch = images.shape
    masks_t = None
    if masks is not None:
        masks_t = torch.as_tensor(masks, dtype=torch.float32, device=dev0)
        if masks_t.ndim == 4:
            masks_t = masks_t.mean(-1)
    if cam is None:
        cam = get_camera(elevation_deg=elevation_deg, distance=distance,
                         fovy_deg=fovy_deg, azimuth_deg=azimuth_deg,
                         num_views=num_views, c2w=c2w, aspect_wh=width / height,
                         device=dev0)
    mesh0, cam0 = mesh.to(dev0), cam.to(dev0)
    if validate_binning:
        _validate_binning_budgets(mesh0, cam0, height, width, uv_size,
                                  raster_config)

    # IoU rejection: a host decision on a silhouette render, before the bake.
    if masks_t is not None and iou_rejection_threshold is not None:
        sil = render(mesh0, cam0, height, width, render_attr=False,
                     render_depth=False, render_normal=False,
                     raster_config=raster_config, device=dev0).mask
        given = (masks_t > 0.5).float()
        rendered = sil.float()
        inter = given * rendered
        union = given + rendered - inter
        iou = (inter.sum((1, 2)) / union.sum((1, 2))).cpu()
        iou_min = float(iou.min())
        if verbose:
            print(f"Per-view IoU: {iou.tolist()}")
        if iou_min < iou_rejection_threshold:
            if verbose:
                print(f"Minimum view IoU {iou_min} below threshold "
                      f"{iou_rejection_threshold}, skipping camera projection")
            return None

    pos_error_eps = _check_validity_bound("pos_error_eps", pos_error_eps)
    depth_grad_threshold = _check_validity_bound("depth_grad_threshold",
                                                 depth_grad_threshold)

    # Once per distinct device: the atlas, the views' geometry, the bounds.
    per_dev = {}
    for dev in dict.fromkeys(band_devices):
        mesh_d, cam_d = mesh.to(dev), cam.to(dev)
        pre = uv_precompute(mesh_d, uv_size, uv_size, raster_config=raster_config,
                            device=dev)
        if pre.uv_attr is None:
            # The from-scratch fill uv_blend_post would make, so the bands
            # can be cut from it.
            pre = pre._replace(uv_attr=torch.ones((uv_size, uv_size, n_ch),
                                                  device=dev))
        view_geo = uv_view_geometry(mesh_d, cam_d, height, width,
                                    compute_depth_grad=True,
                                    depth_grad_dilation=depth_grad_dilation,
                                    raster_config=raster_config, device=dev)
        eps, dg = pos_error_eps, depth_grad_threshold
        if isinstance(eps, str) or isinstance(dg, str):
            footprint = _auto_footprint(cam_d, view_geo.view_mask,
                                        view_geo.view_depth, height)
            if isinstance(eps, str):
                eps = _AUTO_POS_EPS_FOOTPRINTS * footprint
            if isinstance(dg, str):
                dg = _AUTO_DEPTH_GRAD_FOOTPRINTS * footprint
        per_dev[dev] = dict(
            pre=pre, cam=cam_d, geo=view_geo,
            images=images.to(dev),
            masks=None if masks_t is None else masks_t.to(dev),
            validity=SimpleUVValidityStrategy(
                pos_error_eps=eps, aoi_cos_thresh=aoi_cos_valid_threshold,
                depth_grad_thresh=dg),
            weights=ExponentialBlend(alpha=uv_exp_blend_alpha,
                                     view_weight=uv_exp_blend_view_weight))

    # Each band in texel_chunks row chunks: gathers, attributes, view sum.
    rows_per_chunk = uv_size // (n_shards * texel_chunks)
    parts = []
    for b, dev in enumerate(band_devices):
        d = per_dev[dev]
        for k in range(texel_chunks):
            r0 = (b * texel_chunks + k) * rows_per_chunk
            pre_c = _rows(d["pre"], slice(r0, r0 + rows_per_chunk))
            geo = uv_gather_geometry(d["geo"], d["cam"], pre_c, device=dev)
            attr = uv_render_attr(d["images"], geo, masks=d["masks"],
                                  pack_mode=images_pack_mode, device=dev)
            out = uv_blend_sum(pre_c, geo, attr, d["validity"], d["weights"],
                               device=dev)
            parts.append(tuple(t.to(dev0) for t in (
                out.uv_attr_blend, out.uv_valid_mask_blend, geo.uv_depth_grad,
                geo.uv_aoi_cos)))
    blend_raw, valid, depth_grad, aoi_cos = (
        torch.cat(ts, dim=0 if i < 2 else 1) for i, ts in enumerate(zip(*parts)))

    uv_proj = uv_blend_post(
        per_dev[dev0]["pre"], blend_raw, valid, empty_value=1.0,
        do_uv_padding=uv_padding, pad_unseen_area=from_scratch,
        poisson_blending=poisson_blending, pb_num_iters=pb_num_iters,
        pb_keep_original_border=pb_keep_original_border, device=dev0)
    return CameraProjectionOutput(uv_proj=uv_proj, uv_proj_mask=valid,
                                  uv_depth_grad=depth_grad, uv_aoi_cos=aoi_cos)
