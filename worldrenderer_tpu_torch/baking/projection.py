"""CameraProjection: multi-view images (and optional masks) -> a baked UV
texture (PyTorch counterpart of ``worldrenderer_tpu/baking/projection.py``).

uv_precompute -> uv_render_geometry -> IoU rejection -> [warp] ->
uv_render_attr -> uv_blend, on ``device`` (the card unless ``device="cpu"``). Host decisions
read the device once each: the binning-budget guard (``binning_stats``),
the IoU rejection, and nothing else.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..camera import Camera, get_camera
from ..mesh import TexturedMesh
from ..ops.rasterize import DEFAULT_CONFIG, RasterizerConfig, binning_stats
from ..render import render
from ..transforms import get_clip_space_position
from .uv import (
    ExponentialBlend,
    SimpleUVValidityStrategy,
    _uv_clip4,
    uv_blend,
    uv_precompute,
    uv_render_attr,
    uv_render_geometry,
)
from .warp import compute_warp_field

__all__ = ["CameraProjection", "CameraProjectionOutput", "camera_projection"]

# 'auto' validity bounds in units of the per-view pixel footprint
# (_auto_footprint): the reprojection error within 1.5 footprints, the
# depth gradient within 20.
_AUTO_POS_EPS_FOOTPRINTS = 1.5
_AUTO_DEPTH_GRAD_FOOTPRINTS = 20.0


class CameraProjectionOutput(NamedTuple):
    uv_proj: Optional[torch.Tensor]
    uv_proj_mask: Optional[torch.Tensor]
    uv_depth_grad: Optional[torch.Tensor]
    uv_aoi_cos: Optional[torch.Tensor]


def _validate_binning_budgets(mesh: TexturedMesh, cam: Camera, height: int,
                              width: int, uv_size: int,
                              config: RasterizerConfig) -> None:
    """Raise when the config's lossy binning budgets would drop triangles
    in either of the projection's rasterizations: the view render of
    t_pos_idx, and the UV atlas of t_tex_idx, which runs with the cull off
    (as :func:`uv_precompute` does)."""
    if config.bin_mode != "sort_pairs":
        return
    checks = []
    if mesh.t_pos_idx.shape[0] >= config.bin_sort_pairs_min_tris:
        checks.append(("view-space render",
                       get_clip_space_position(mesh.v_pos, cam.mvp_mtx),
                       mesh.t_pos_idx, (height, width), config))
    if (mesh.v_tex is not None
            and mesh.t_tex_idx.shape[0] >= config.bin_sort_pairs_min_tris):
        checks.append(("UV-atlas rasterization", _uv_clip4(mesh.v_tex)[None],
                       mesh.t_tex_idx, (uv_size, uv_size),
                       config._replace(backface_cull=0)))
    for name, pos, tri, resolution, cfg in checks:
        stats = binning_stats(pos, tri, resolution, cfg)
        if not stats["ok"]:
            raise ValueError(
                f"camera_projection: rasterizer binning budgets are lossy "
                f"for this scene's {name} at {resolution}: {stats}. Raise "
                f"the failing budget (max_tris_per_tile >= max_per_tile, "
                f"bin_huge >= n_huge, bin_flat_cap_factor * T >= "
                f"live_entries) in the RasterizerConfig, or pass "
                f"validate_binning=False to accept dropped triangles.")


def _nanmedian_rows(x: torch.Tensor) -> torch.Tensor:
    """Median of each row of (N, M) ignoring NaN, as ``jnp.nanmedian``:
    the two middle values of an even count weigh 1/2 each, and a row of
    NaN gives NaN. From one sort (``torch.nanmedian`` returns the lower
    middle value, and ``torch.nanquantile`` refuses rows above 2^24)."""
    srt = torch.sort(x, dim=1).values  # NaN sorts last
    counts = (~torch.isnan(x)).sum(dim=1, keepdim=True).float()
    q = 0.5 * (counts - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w
    low = torch.clamp(torch.minimum(low, counts - 1.0), min=0.0).long()
    high = torch.clamp(torch.minimum(high, counts - 1.0), min=0.0).long()
    return (torch.gather(srt, 1, low) * low_w
            + torch.gather(srt, 1, high) * high_w)[:, 0]


def _auto_footprint(cam: Camera, view_mask, view_depth, height: int):
    """Per-view world-space pixel footprint, (Nv, 1, 1): median foreground
    depth * 2 tan(fovy/2) / rows for perspective views (tan(fovy/2) =
    1/|p11|), 2 / (|p11| rows) for orthographic ones. A view without
    foreground gives NaN, so its texels are never valid."""
    inv_f = 1.0 / cam.proj_mtx[:, 1, 1].abs()
    is_persp = cam.proj_mtx[:, 3, 3].abs() < 0.5
    depth_fg = torch.where(view_mask, view_depth, torch.nan)
    med = _nanmedian_rows(depth_fg.reshape(depth_fg.shape[0], -1))
    fp = torch.where(is_persp, med, 1.0) * 2.0 * inv_f
    # a true division: over a Python number the card multiplies by its
    # rounded reciprocal
    return (fp / torch.full_like(fp, float(height)))[:, None, None]


def _auto_pack_mode(images) -> str:
    """"u8" when host (numpy) images are 255-quantized within 1e-4, else
    "none"; a tensor is never read back to decide."""
    if isinstance(images, np.ndarray) and images.size:
        a = images.astype(np.float32, copy=False)
        if a.min() >= 0.0 and a.max() <= 1.0:
            r = a * 255.0
            if np.abs(r - np.round(r)).max() <= 1e-4:
                return "u8"
    return "none"


def camera_projection(
    images,
    mesh: TexturedMesh,
    cam: Optional[Camera] = None,
    fovy_deg=None,
    masks=None,
    bg_remover=None,
    remove_bg: bool = False,
    c2w=None,
    elevation_deg=None,
    distance=None,
    azimuth_deg=None,
    num_views: Optional[int] = None,
    uv_size: int = 2048,
    warp_images: bool = False,
    images_background: Optional[float] = None,
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
    device_mesh=None,
    device_mesh_axis: str = "uv",
    texel_chunks: int = 1,
    device: DeviceLike = None,
) -> Optional[CameraProjectionOutput]:
    """Project multi-view images (Nv, H, W, C) onto the mesh's UV texture
    on ``device`` (the card unless ``device="cpu"``).

    Returns None when the given masks disagree with the rendered
    silhouettes: a view's IoU below ``iou_rejection_threshold``.
    ``pos_error_eps`` and ``depth_grad_threshold`` are world-unit bounds or
    "auto" (1.5 and 20 per-view pixel footprints). ``images_pack_mode``
    "auto" packs the view->UV gather as bytes when numpy ``images`` are
    255-quantized. ``validate_binning`` raises when the config's binning
    budgets would drop triangles in either rasterization. ``bg_remover`` is
    the caller's callable, images -> masks (a ``SegmentationModel``).
    ``warp_images`` first fits each view to a render of the mesh over
    ``images_background`` (``compute_warp_field``; square views)."""
    del device_mesh_axis, texel_chunks  # the sharded bake's; see below
    if device_mesh is not None:
        raise NotImplementedError(
            "device_mesh (the texel-sharded multi-device bake) is not ported "
            "yet: ROADMAP queue 1, item 12")
    if warp_images and images_background is None:
        raise ValueError("warp_images needs images_background, the "
                         "background of the renders the views are fitted to")
    dev = resolve_device(device)
    if images_pack_mode == "auto":
        # Warped images are no longer 255-quantized.
        images_pack_mode = "none" if warp_images else _auto_pack_mode(images)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    if images.ndim != 4:
        raise ValueError("images must be (Nv, H, W, C)")
    _, height, width, _ = images.shape
    mesh = mesh.to(dev)

    masks_t = None
    if masks is not None:
        masks_t = torch.as_tensor(masks, dtype=torch.float32, device=dev)
    elif remove_bg:
        if bg_remover is None:
            raise ValueError("remove_bg requires a bg_remover")
        masks_t = torch.as_tensor(bg_remover(images), dtype=torch.float32,
                                  device=dev)
    if masks_t is not None and masks_t.ndim == 4:
        masks_t = masks_t.mean(-1)

    if cam is None:
        cam = get_camera(elevation_deg=elevation_deg, distance=distance,
                         fovy_deg=fovy_deg, azimuth_deg=azimuth_deg,
                         num_views=num_views, c2w=c2w,
                         aspect_wh=width / height, device=dev)
    cam = cam.to(dev)
    if validate_binning:
        _validate_binning_budgets(mesh, cam, height, width, uv_size,
                                  raster_config)

    pre = uv_precompute(mesh, uv_size, uv_size, raster_config=raster_config,
                        device=dev)
    geo = uv_render_geometry(
        mesh, cam, height, width, pre, compute_depth_grad=True,
        depth_grad_dilation=depth_grad_dilation, raster_config=raster_config,
        device=dev,
    )

    if masks_t is not None and iou_rejection_threshold is not None:
        given = (masks_t > 0.5).float()
        rendered = geo.view_mask.float()
        inter = given * rendered
        union = given + rendered - inter
        iou = (inter.sum((1, 2)) / union.sum((1, 2))).cpu()  # one host read
        iou_min = float(iou.min())
        if verbose:
            print(f"Per-view IoU: {iou.tolist()}")
        if iou_min < iou_rejection_threshold:
            if verbose:
                print(f"Minimum view IoU {iou_min} below threshold "
                      f"{iou_rejection_threshold}, skipping camera projection")
            return None

    if warp_images:
        target = render(mesh, cam, height, width, render_attr=True,
                        render_depth=False, render_normal=False,
                        attr_background=images_background,
                        raster_config=raster_config, device=dev).attr
        images = compute_warp_field(images, target, n_grid=10,
                                    optim_res=(64, 128), optim_step_per_res=20,
                                    lambda_reg=2.0, device=dev)

    attr = uv_render_attr(images, geo, masks=masks_t,
                          pack_mode=images_pack_mode, device=dev)
    for name, v in (("pos_error_eps", pos_error_eps),
                    ("depth_grad_threshold", depth_grad_threshold)):
        if isinstance(v, str) and v != "auto":
            raise ValueError(f"{name}: float or 'auto', got {v!r}")
    if isinstance(pos_error_eps, str) or isinstance(depth_grad_threshold, str):
        footprint = _auto_footprint(cam, geo.view_mask, geo.view_depth, height)
        if isinstance(pos_error_eps, str):
            pos_error_eps = _AUTO_POS_EPS_FOOTPRINTS * footprint
        if isinstance(depth_grad_threshold, str):
            depth_grad_threshold = _AUTO_DEPTH_GRAD_FOOTPRINTS * footprint
    blend = uv_blend(
        pre, geo, attr,
        uv_validity_strategy=SimpleUVValidityStrategy(
            pos_error_eps=pos_error_eps, aoi_cos_thresh=aoi_cos_valid_threshold,
            depth_grad_thresh=depth_grad_threshold),
        uv_blend_weight_strategy=ExponentialBlend(
            alpha=uv_exp_blend_alpha, view_weight=uv_exp_blend_view_weight),
        empty_value=1.0, do_uv_padding=uv_padding, pad_unseen_area=from_scratch,
        poisson_blending=poisson_blending, pb_num_iters=pb_num_iters,
        pb_keep_original_border=pb_keep_original_border, device=dev,
    )
    return CameraProjectionOutput(
        uv_proj=blend.uv_attr_blend, uv_proj_mask=blend.uv_valid_mask_blend,
        uv_depth_grad=geo.uv_depth_grad, uv_aoi_cos=geo.uv_aoi_cos,
    )


class CameraProjection:
    """The reference's projector object: carries a background remover, a
    rasterizer config and a device; ``pb_backend`` and ``context_type``
    name the reference's implementations and are accepted and ignored."""

    def __init__(self, pb_backend: str = "torch", bg_remover=None,
                 device: DeviceLike = None, context_type: str = "cuda",
                 raster_config: RasterizerConfig = DEFAULT_CONFIG) -> None:
        del pb_backend, context_type
        self.bg_remover = bg_remover
        self.device = device
        self.raster_config = raster_config

    def __call__(self, images, mesh, **kwargs):
        return_dict = kwargs.pop("return_dict", False)
        return_mask = kwargs.pop("return_uv_projection_mask", False)
        kwargs.setdefault("raster_config", self.raster_config)
        kwargs.setdefault("bg_remover", self.bg_remover)
        kwargs.setdefault("device", self.device)
        out = camera_projection(images, mesh, **kwargs)
        if out is None:
            return None
        if return_dict:
            return out
        if return_mask:
            return out.uv_proj, out.uv_proj_mask
        return out.uv_proj
