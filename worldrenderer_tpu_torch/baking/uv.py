"""UV-space rasterization, view -> UV projection and multi-view blending
(PyTorch counterpart of ``worldrenderer_tpu/baking/uv.py``).

Every public function runs on ``device`` (the card unless
``device="cpu"``) and moves its inputs there. The strategies are
NamedTuple callables as in the JAX package; ``RandomChoiceBlend`` takes an
explicit ``torch.Generator`` in place of the JAX key. Sums over views are
written out in view order, so the card's sums carry the CPU's bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..camera import Camera, normalize
from ..mesh import TexturedMesh
from ..ops.gbuffer import rasterize_gbuffer
from ..ops.grid_sample import grid_sample, grid_sample_parts
from ..ops.image import inpaint, max_pool2d, sobel_grad_magnitude
from ..ops.interpolate import interpolate
from ..ops.poisson import (
    poisson_blend,
    poisson_blend_cropped,
    poisson_blend_multigrid,
)
from ..ops.rasterize import DEFAULT_CONFIG, RasterizerConfig, rasterize
from ..ops.tensor import fma_dot3, sqrt_f32
from ..render import SimpleNormalization, render
from ..transforms import get_clip_space_position

__all__ = [
    "UVPrecomputeOutput",
    "UVRenderGeometryOutput",
    "UVRenderAttrOutput",
    "UVBlendOutput",
    "SimpleUVValidityStrategy",
    "ExponentialBlend",
    "RandomChoiceBlend",
    "uv_precompute",
    "uv_render_geometry",
    "UVViewGeometry",
    "uv_view_geometry",
    "uv_gather_geometry",
    "uv_render_attr",
    "uv_blend",
    "uv_blend_sum",
    "uv_blend_post",
    "uv_padding",
]


def _to(nt, dev):
    """A NamedTuple with every tensor field moved to ``dev``."""
    return nt._replace(**{
        k: v.to(dev) for k, v in nt._asdict().items()
        if isinstance(v, torch.Tensor)
    })


def _sum_views(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (view) axis, in view order."""
    out = x[0]
    for v in x[1:]:
        out = out + v
    return out


class UVPrecomputeOutput(NamedTuple):
    height: int
    width: int
    uv_attr: Optional[torch.Tensor]  # (Huv, Wuv, C) current texture
    uv_mask: torch.Tensor  # (Huv, Wuv) bool: inside a UV chart
    uv_pos: torch.Tensor  # (Huv, Wuv, 3) world position per texel


def _uv_clip4(v_tex: torch.Tensor) -> torch.Tensor:
    """UVs as (V, 4) clip positions: (2u - 1, 2v - 1, 0, 1)."""
    uv_clip = v_tex * 2.0 - 1.0
    return torch.cat([uv_clip, torch.zeros_like(uv_clip[..., :1]),
                      torch.ones_like(uv_clip[..., :1])], dim=-1)


def uv_precompute(
    mesh: TexturedMesh,
    height: int,
    width: int,
    raster_config: RasterizerConfig = DEFAULT_CONFIG,
    device: DeviceLike = None,
) -> UVPrecomputeOutput:
    """Rasterize the mesh in UV space (UVs as clip positions): per-texel
    world position and chart mask. Backface culling is forced off (a
    chart's winding is set by the unwrap, not by 3D facing). At least
    ``bin_sort_pairs_min_tris`` texture triangles take one fused G-buffer
    pass that interpolates v_pos over t_pos_idx (K1 for the K1 backends);
    fewer take classic ``rasterize`` (K4) and ``interpolate``."""
    dev = resolve_device(device)
    mesh = mesh.to(dev)
    if raster_config.backface_cull:
        raster_config = raster_config._replace(backface_cull=0)
    uv_clip4 = _uv_clip4(mesh.v_tex)
    if (raster_config.bin_mode == "sort_pairs"
            and mesh.t_tex_idx.shape[0] >= raster_config.bin_sort_pairs_min_tris):
        gb = rasterize_gbuffer(
            uv_clip4[None], mesh.t_tex_idx, mesh.v_pos, (height, width),
            raster_config, tri_attr=mesh.t_pos_idx, device=dev,
        )
        uv_mask, uv_pos = gb.mask[0], gb.attr[0]
    else:
        rast = rasterize(uv_clip4[None], mesh.t_tex_idx, (height, width),
                         raster_config, device=dev)
        uv_mask = rast[0, :, :, 3] > 0
        uv_pos = interpolate(mesh.v_pos[None], rast, mesh.t_pos_idx,
                             device=dev)[0]
    return UVPrecomputeOutput(height=height, width=width, uv_attr=mesh.texture,
                              uv_mask=uv_mask, uv_pos=uv_pos)


class UVRenderGeometryOutput(NamedTuple):
    uv_pos_proj: torch.Tensor  # (Nv, Huv, Wuv, 3) view positions at texels
    uv_pos_error: torch.Tensor  # (Nv, Huv, Wuv) reprojection error
    uv_aoi_cos: torch.Tensor  # (Nv, Huv, Wuv) angle-of-incidence cosine
    uv_pos_ndc: torch.Tensor  # (Nv, Huv, Wuv, 2) NDC of each texel per view
    view_mask: torch.Tensor  # (Nv, H, W)
    view_normal: torch.Tensor  # (Nv, H, W, 3)
    view_aoi_cos: torch.Tensor  # (Nv, H, W)
    view_position: torch.Tensor  # (Nv, H, W, 3)
    view_depth: torch.Tensor  # (Nv, H, W)
    view_depth_grad: Optional[torch.Tensor] = None
    uv_depth_grad: Optional[torch.Tensor] = None
    view_attr: Optional[torch.Tensor] = None
    uv_attr_proj: Optional[torch.Tensor] = None
    uv_mask_proj: Optional[torch.Tensor] = None


class UVViewGeometry(NamedTuple):
    """The view-space half of :func:`uv_render_geometry`: the rendered
    per-view maps every texel gathers from."""

    view_mask: torch.Tensor
    view_normal: torch.Tensor
    view_aoi_cos: torch.Tensor
    view_position: torch.Tensor
    view_depth: torch.Tensor
    view_depth_grad: Optional[torch.Tensor] = None
    view_attr: Optional[torch.Tensor] = None


def uv_view_geometry(
    mesh: TexturedMesh,
    cam: Camera,
    view_height: int,
    view_width: int,
    compute_depth_grad: bool = False,
    depth_grad_dilation: int = 1,
    render_attr: bool = False,
    raster_config: RasterizerConfig = DEFAULT_CONFIG,
    device: DeviceLike = None,
) -> UVViewGeometry:
    """Render the per-view G-buffers and the maps derived from them: the
    camera-space angle-of-incidence cosine and the dilated depth
    gradient."""
    dev = resolve_device(device)
    cam = cam.to(dev)
    out = render(
        mesh, cam, view_height, view_width,
        render_attr=render_attr, render_depth=True, render_normal=True,
        depth_normalization_strategy=SimpleNormalization(
            scale=1.0, offset=0.0, clamp=False, bg_value=1e2),
        raster_config=raster_config, device=dev,
    )
    view_mask, view_normal = out.mask, out.normal
    # normal @ R^T with R = w2c[:3, :3], rounded as the reference's fp32
    # einsum (a chain of FMAs), never as a TF32 matmul.
    rot = cam.w2c[:, None, None, :3, :3]  # (B, 1, 1, 3 i, 3 j)
    view_normal_cs = fma_dot3(view_normal[..., None, :], rot, -1)
    view_normal_cs = normalize(view_normal_cs)
    view_normal_cs = torch.where(view_mask[..., None], view_normal_cs,
                                 view_normal)
    view_aoi_cos = torch.clamp(view_normal_cs[..., 2], 0.0, 1.0)
    view_depth_grad = None
    if compute_depth_grad:
        view_depth_grad = sobel_grad_magnitude(out.depth, device=dev)
        view_depth_grad = max_pool2d(view_depth_grad, depth_grad_dilation,
                                     device=dev)
    return UVViewGeometry(
        view_mask=view_mask, view_normal=view_normal,
        view_aoi_cos=view_aoi_cos, view_position=out.pos,
        view_depth=out.depth, view_depth_grad=view_depth_grad,
        view_attr=out.attr if render_attr else None,
    )


def uv_gather_geometry(
    view_geo: UVViewGeometry,
    cam: Camera,
    uv_precompute_output: UVPrecomputeOutput,
    grid_sample_mode: str = "bilinear",
    sample_images: Optional[torch.Tensor] = None,
    sample_masks: Optional[torch.Tensor] = None,
    images_pack_mode: str = "none",
    device: DeviceLike = None,
) -> UVRenderGeometryOutput:
    """The texel-space half of :func:`uv_render_geometry`: project each
    texel's world position into every view and gather the view maps (and
    optional images / masks) there, in one row gather."""
    dev = resolve_device(device)
    view_geo, pre, cam = _to(view_geo, dev), _to(uv_precompute_output, dev), cam.to(dev)
    batch_size = len(cam)
    height, width, _ = pre.uv_pos.shape
    compute_depth_grad = view_geo.view_depth_grad is not None

    uv_pos_clip = get_clip_space_position(
        pre.uv_pos.reshape(-1, 3), cam.mvp_mtx
    ).reshape(batch_size, height, width, 4)
    uv_pos_ndc = uv_pos_clip[..., :2] / uv_pos_clip[..., 3:4]

    stack = [view_geo.view_position, view_geo.view_aoi_cos[..., None]]
    if compute_depth_grad:
        stack.append(view_geo.view_depth_grad[..., None])
    n_geo = sum(s.shape[-1] for s in stack)
    parts = [(torch.cat(stack, dim=-1), "none")]
    uv_attr_proj = uv_mask_proj = uv_depth_grad = None
    if sample_images is not None:
        sample_images = torch.as_tensor(sample_images, dtype=torch.float32,
                                        device=dev)
        parts.append((sample_images, images_pack_mode))
    if sample_masks is not None:
        sample_masks = torch.as_tensor(sample_masks, dtype=torch.float32,
                                       device=dev)
        if sample_masks.ndim == 4:
            sample_masks = sample_masks.mean(-1)
        parts.append((sample_masks[..., None], "none"))
    if grid_sample_mode == "bilinear":
        sampled = grid_sample_parts(parts, uv_pos_ndc, device=dev)
    else:
        sampled = torch.cat([grid_sample(im, uv_pos_ndc, mode=grid_sample_mode,
                                         device=dev) for im, _ in parts], dim=-1)
    uv_pos_proj = sampled[..., :3]
    uv_aoi_cos = sampled[..., 3]
    if compute_depth_grad:
        uv_depth_grad = sampled[..., 4]
    at = n_geo
    if sample_images is not None:
        nc = sample_images.shape[-1]
        uv_attr_proj = sampled[..., at:at + nc]
        at += nc
    if sample_masks is not None:
        uv_mask_proj = sampled[..., at]
    d = uv_pos_proj - pre.uv_pos[None]
    uv_pos_error = sqrt_f32((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                            + d[..., 2] * d[..., 2])
    return UVRenderGeometryOutput(
        uv_pos_proj=uv_pos_proj, uv_pos_error=uv_pos_error,
        uv_aoi_cos=uv_aoi_cos, uv_pos_ndc=uv_pos_ndc,
        view_mask=view_geo.view_mask, view_position=view_geo.view_position,
        view_normal=view_geo.view_normal, view_aoi_cos=view_geo.view_aoi_cos,
        view_depth=view_geo.view_depth,
        view_depth_grad=view_geo.view_depth_grad, uv_depth_grad=uv_depth_grad,
        view_attr=view_geo.view_attr, uv_attr_proj=uv_attr_proj,
        uv_mask_proj=uv_mask_proj,
    )


def uv_render_geometry(
    mesh: TexturedMesh,
    cam: Camera,
    view_height: int,
    view_width: int,
    uv_precompute_output: UVPrecomputeOutput,
    grid_sample_mode: str = "bilinear",
    compute_depth_grad: bool = False,
    depth_grad_dilation: int = 1,
    render_attr: bool = False,
    raster_config: RasterizerConfig = DEFAULT_CONFIG,
    sample_images: Optional[torch.Tensor] = None,
    sample_masks: Optional[torch.Tensor] = None,
    images_pack_mode: str = "none",
    device: DeviceLike = None,
) -> UVRenderGeometryOutput:
    """Per-view geometric correspondence of every texel:
    :func:`uv_view_geometry` then :func:`uv_gather_geometry`.
    ``sample_images`` / ``sample_masks`` ride the same row gather (into
    ``uv_attr_proj`` / ``uv_mask_proj``), equal to a separate
    :func:`uv_render_attr` call bit for bit."""
    view_geo = uv_view_geometry(
        mesh, cam, view_height, view_width,
        compute_depth_grad=compute_depth_grad,
        depth_grad_dilation=depth_grad_dilation, render_attr=render_attr,
        raster_config=raster_config, device=device,
    )
    return uv_gather_geometry(
        view_geo, cam, uv_precompute_output,
        grid_sample_mode=grid_sample_mode, sample_images=sample_images,
        sample_masks=sample_masks, images_pack_mode=images_pack_mode,
        device=device,
    )


class UVRenderAttrOutput(NamedTuple):
    uv_attr_proj: torch.Tensor  # (Nv, Huv, Wuv, C)
    uv_mask_proj: Optional[torch.Tensor]  # (Nv, Huv, Wuv)


def uv_render_attr(
    images: torch.Tensor,
    uv_render_geometry_output: UVRenderGeometryOutput,
    masks: Optional[torch.Tensor] = None,
    grid_sample_mode: str = "bilinear",
    pack_mode: str = "none",
    device: DeviceLike = None,
) -> UVRenderAttrOutput:
    """Sample the view images (and optional masks) into UV space.
    ``pack_mode="u8"`` gathers the image taps byte-packed (exact for
    255-quantized images); the masks ride unpacked fp32 columns of the same
    gather."""
    dev = resolve_device(device)
    ndc = uv_render_geometry_output.uv_pos_ndc.to(dev)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    uv_mask_proj = None
    if masks is not None:
        masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
        if masks.ndim == 4:
            masks = masks.mean(-1)
        if grid_sample_mode == "bilinear":
            sampled = grid_sample_parts(
                [(images, pack_mode), (masks[..., None], "none")], ndc,
                device=dev)
        else:
            sampled = grid_sample(torch.cat([images, masks[..., None]], dim=-1),
                                  ndc, mode=grid_sample_mode, device=dev)
        uv_attr_proj = sampled[..., :-1]
        uv_mask_proj = sampled[..., -1]
    else:
        uv_attr_proj = grid_sample(images, ndc, mode=grid_sample_mode,
                                   pack_mode=pack_mode, device=dev)
    return UVRenderAttrOutput(uv_attr_proj=uv_attr_proj,
                              uv_mask_proj=uv_mask_proj)


# ---- Validity and blend-weight strategies ---------------------------------


class SimpleUVValidityStrategy(NamedTuple):
    """Per-texel, per-view validity: reprojection error < eps, aoi-cos >
    thresh, (optional) depth gradient < thresh, inside a chart and
    (optional) the sampled view mask > thresh. The bounds are floats or
    tensors that broadcast against (Nv, Huv, Wuv)."""

    pos_error_eps: float = 1e-3
    aoi_cos_thresh: float = 0.1
    mask_thresh: float = 0.9
    depth_grad_thresh: Optional[float] = None
    first_view_dominate: bool = False

    def __call__(self, uv_precompute_output, uv_render_geometry_output,
                 uv_render_attr_output):
        geo = uv_render_geometry_output
        valid = ((geo.uv_pos_error < self.pos_error_eps)
                 & (geo.uv_aoi_cos > self.aoi_cos_thresh))
        if self.depth_grad_thresh is not None and geo.uv_depth_grad is not None:
            valid = valid & (geo.uv_depth_grad < self.depth_grad_thresh)
        valid = valid & uv_precompute_output.uv_mask[None]
        if (uv_render_attr_output is not None
                and uv_render_attr_output.uv_mask_proj is not None):
            valid = valid & (uv_render_attr_output.uv_mask_proj > self.mask_thresh)
        if self.first_view_dominate:
            # Views 1.. lose wherever view 0 is valid.
            valid = torch.cat([valid[:1], valid[1:] & ~valid[:1]], dim=0)
        return valid


class ExponentialBlend(NamedTuple):
    """aoi-cos^alpha blend weights, linear or softmax normalized over
    views; ``view_weight`` (Nv,) divides alpha per view."""

    alpha: float = 1.0
    normalization: str = "linear"
    view_weight: Optional[torch.Tensor] = None

    def __call__(self, uv_precompute_output, uv_render_geometry_output,
                 uv_render_attr_output, uv_valid_mask):
        weight = uv_render_geometry_output.uv_aoi_cos * uv_valid_mask.float()
        if self.view_weight is not None:
            vw = torch.as_tensor(self.view_weight, dtype=torch.float32,
                                 device=weight.device)
            # alpha / vw as a true division (a scalar over a tensor on the
            # card is a reciprocal times the scalar)
            weight = weight ** (torch.full_like(vw, self.alpha) / vw)[:, None, None]
        else:
            weight = weight ** self.alpha
        if self.normalization == "linear":
            total = torch.clamp(_sum_views(weight), min=1e-5)
            return torch.clamp(weight / total, 0.0, 1.0)
        if self.normalization == "softmax":
            weight = torch.where(uv_valid_mask, weight, -1e5)
            return torch.softmax(weight, dim=0)
        raise ValueError(f"unknown normalization {self.normalization!r}")


def _random_choice_weights(weight: torch.Tensor, rand: torch.Tensor) -> torch.Tensor:
    """One-hot (Nv, Huv, Wuv) weights from per-view weights and uniform
    draws of the same shape: at each texel the view of the largest draw
    among those of positive weight (view 0 where none has one)."""
    weight = torch.where(weight > 0, rand, weight)
    choice = torch.argmax(weight, dim=0)
    return F.one_hot(choice, weight.shape[0]).permute(2, 0, 1).float()


class RandomChoiceBlend(NamedTuple):
    """One-hot weights choosing a random valid view per texel; the draws
    come from ``generator`` (on the device it names)."""

    generator: torch.Generator
    alpha: float = 1.0  # accepted for parity; unused, as in the reference

    def __call__(self, uv_precompute_output, uv_render_geometry_output,
                 uv_render_attr_output, uv_valid_mask):
        weight = uv_render_geometry_output.uv_aoi_cos * uv_valid_mask.float()
        rand = torch.rand(weight.shape, generator=self.generator,
                          device=self.generator.device)
        return _random_choice_weights(weight, rand.to(weight.device))


def uv_padding(attr: torch.Tensor, inside_mask: torch.Tensor, radius: int,
               device: DeviceLike = None) -> torch.Tensor:
    """Pad UV gutters: inpaint outside ``inside_mask``, ``radius`` steps."""
    dev = resolve_device(device)
    attr = torch.as_tensor(attr, dtype=torch.float32, device=dev)
    inside = torch.as_tensor(inside_mask, device=dev).bool()
    return inpaint(torch.clamp(attr, 0.0, 1.0), ~inside, radius, device=dev)


class UVBlendOutput(NamedTuple):
    uv_attr_blend: Optional[torch.Tensor]
    uv_valid_mask: torch.Tensor
    uv_valid_mask_blend: torch.Tensor
    uv_blend_weight: torch.Tensor


def uv_blend(
    uv_precompute_output: UVPrecomputeOutput,
    uv_render_geometry_output: UVRenderGeometryOutput,
    uv_render_attr_output: Optional[UVRenderAttrOutput],
    uv_validity_strategy=SimpleUVValidityStrategy(),
    uv_blend_weight_strategy=ExponentialBlend(),
    empty_value: float = 0.0,
    do_uv_padding: bool = True,
    uv_padding_radius: int = 3,
    pad_unseen_area: bool = False,
    poisson_blending: bool = False,
    pb_num_iters: int = 1000,
    pb_keep_original_border: bool = True,
    pb_grad_mode: str = "src",
    pb_solver: str = "jacobi",
    device: DeviceLike = None,
) -> UVBlendOutput:
    """Weighted multi-view blend into one texture (:func:`uv_blend_sum`),
    then optional Poisson seam blending and UV gutter padding
    (:func:`uv_blend_post`). ``pb_solver``: "jacobi" (the reference's
    sweeps), "multigrid" (``pb_num_iters`` sweeps per level) or "cropped"
    (the mask's bounding box only)."""
    out = uv_blend_sum(uv_precompute_output, uv_render_geometry_output,
                       uv_render_attr_output,
                       uv_validity_strategy=uv_validity_strategy,
                       uv_blend_weight_strategy=uv_blend_weight_strategy,
                       device=device)
    if out.uv_attr_blend is None:
        return out
    uv_attr_blend = uv_blend_post(
        uv_precompute_output, out.uv_attr_blend, out.uv_valid_mask_blend,
        empty_value=empty_value, do_uv_padding=do_uv_padding,
        uv_padding_radius=uv_padding_radius, pad_unseen_area=pad_unseen_area,
        poisson_blending=poisson_blending, pb_num_iters=pb_num_iters,
        pb_keep_original_border=pb_keep_original_border,
        pb_grad_mode=pb_grad_mode, pb_solver=pb_solver, device=device,
    )
    return out._replace(uv_attr_blend=uv_attr_blend)


def uv_blend_sum(
    uv_precompute_output: UVPrecomputeOutput,
    uv_render_geometry_output: UVRenderGeometryOutput,
    uv_render_attr_output: Optional[UVRenderAttrOutput],
    uv_validity_strategy=SimpleUVValidityStrategy(),
    uv_blend_weight_strategy=ExponentialBlend(),
    device: DeviceLike = None,
) -> UVBlendOutput:
    """The per-texel half of :func:`uv_blend`: validity, blend weights and
    the raw weighted view sum (no stitching, padding or Poisson)."""
    dev = resolve_device(device)
    pre = _to(uv_precompute_output, dev)
    geo = _to(uv_render_geometry_output, dev)
    attr = None if uv_render_attr_output is None else _to(uv_render_attr_output, dev)
    uv_valid_mask = uv_validity_strategy(pre, geo, attr)
    uv_blend_weight = uv_blend_weight_strategy(pre, geo, attr, uv_valid_mask)
    uv_valid_mask_blend = uv_valid_mask.any(dim=0)
    uv_attr_blend = None
    if attr is not None:
        uv_attr_blend = _sum_views(attr.uv_attr_proj * uv_blend_weight[..., None])
    return UVBlendOutput(uv_attr_blend=uv_attr_blend, uv_valid_mask=uv_valid_mask,
                         uv_valid_mask_blend=uv_valid_mask_blend,
                         uv_blend_weight=uv_blend_weight)


def uv_blend_post(
    uv_precompute_output: UVPrecomputeOutput,
    uv_attr_blend: torch.Tensor,
    uv_valid_mask_blend: torch.Tensor,
    empty_value: float = 0.0,
    do_uv_padding: bool = True,
    uv_padding_radius: int = 3,
    pad_unseen_area: bool = False,
    poisson_blending: bool = False,
    pb_num_iters: int = 1000,
    pb_keep_original_border: bool = True,
    pb_grad_mode: str = "src",
    pb_solver: str = "jacobi",
    device: DeviceLike = None,
) -> torch.Tensor:
    """The whole-image half of :func:`uv_blend`: stitch the raw weighted
    sum against the original texture (``empty_value`` where the mesh has
    none), then optional Poisson seam blending and gutter padding."""
    dev = resolve_device(device)
    pre = _to(uv_precompute_output, dev)
    uv_attr_blend = torch.as_tensor(uv_attr_blend, dtype=torch.float32, device=dev)
    blend_mask = torch.as_tensor(uv_valid_mask_blend, device=dev).bool()
    if pre.uv_attr is not None and tuple(pre.uv_attr.shape[:2]) != (pre.height,
                                                                  pre.width):
        raise ValueError(
            f"mesh.texture is {tuple(pre.uv_attr.shape[:2])} but uv_size is "
            f"({pre.height}, {pre.width}): they must match (the blend "
            "stitches against the original texture)")
    if pre.uv_attr is None:
        pre = pre._replace(uv_attr=torch.full_like(uv_attr_blend, empty_value))
    blend_f = blend_mask[..., None].float()
    if poisson_blending:
        if not do_uv_padding:
            raise ValueError("poisson blending requires uv padding")
        padded = uv_padding(uv_attr_blend, blend_mask, uv_padding_radius,
                            device=dev)
        if pb_keep_original_border:
            pb_tgt = pre.uv_attr
        else:
            hard = uv_attr_blend * blend_f + pre.uv_attr * (1.0 - blend_f)
            pb_tgt = uv_padding(hard, pre.uv_mask, uv_padding_radius, device=dev)
        solvers = {"jacobi": poisson_blend, "multigrid": poisson_blend_multigrid,
                   "cropped": poisson_blend_cropped}
        if pb_solver not in solvers:
            raise ValueError(f"unknown pb_solver {pb_solver!r}")
        uv_attr_blend = solvers[pb_solver](
            padded, blend_mask, pb_tgt, num_iters=pb_num_iters,
            grad_mode=pb_grad_mode, device=dev)
    else:
        uv_attr_blend = uv_attr_blend * blend_f + pre.uv_attr * (1.0 - blend_f)
    if do_uv_padding:
        content_mask = blend_mask if pad_unseen_area else pre.uv_mask
        uv_attr_blend = uv_padding(uv_attr_blend, content_mask,
                                   uv_padding_radius, device=dev)
    return uv_attr_blend
