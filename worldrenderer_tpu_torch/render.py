"""G-buffer rendering: mask / position / depth / normal maps for a batch of
views (PyTorch counterpart of ``worldrenderer_tpu/render.py``; textured
colour, tangents, supersampling and view chunking come in a later slice).

The fused branch (``backend`` "auto", "fused_pallas" or "fused_xla")
rasterizes every channel as attribute planes in one pass; every other
backend takes the classic branch, ``rasterize`` then ``interpolate``, as the
JAX package's ``render`` routes them (so ``"vpu_pallas"`` reaches kernel K3
through ``rasterize_gbuffer``, not through ``render``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ._device import DeviceLike, resolve_device
from .camera import Camera, normalize
from .mesh import TexturedMesh, compute_vertex_normals, with_normals
from .ops.gbuffer import rasterize_gbuffer
from .ops.interpolate import interpolate
from .ops.rasterize import DEFAULT_CONFIG, RasterizerConfig, rasterize
from .transforms import get_clip_space_position, transform_points_homo

__all__ = [
    "RenderOutput",
    "render",
    "DepthControlNetNormalization",
    "Zero123PlusPlusNormalization",
    "SimpleNormalization",
]


class RenderOutput(NamedTuple):
    attr: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None
    normal: Optional[torch.Tensor] = None
    tangent: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None


def _view_min_max(depth: torch.Tensor):
    flat = depth.reshape(depth.shape[0], -1)
    return flat.amin(dim=1)[:, None, None], flat.amax(dim=1)[:, None, None]


class DepthControlNetNormalization(NamedTuple):
    """Inverted per-view min/max depth."""

    far_clip: float = 0.25
    near_clip: float = 1.0
    bg_value: float = 0.0

    def __call__(self, depth: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        mn, mx = _view_min_max(depth)
        d = 1.0 - torch.clamp((depth - mn) / (mx - mn + 1e-5), 0.0, 1.0)
        d = d * (self.near_clip - self.far_clip) + self.far_clip
        return torch.where(mask, d, self.bg_value)


class Zero123PlusPlusNormalization(NamedTuple):
    """Per-view min/max depth."""

    bg_value: float = 0.8

    def __call__(self, depth: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        mn, mx = _view_min_max(depth)
        d = torch.clamp((depth - mn) / (mx - mn + 1e-5), 0.0, 1.0)
        return torch.where(mask, d, self.bg_value)


class SimpleNormalization(NamedTuple):
    """Affine scale/offset depth mapping."""

    scale: float = 1.0
    offset: float = -1.0
    clamp: bool = True
    bg_value: float = 1.0

    def __call__(self, depth: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        d = depth * self.scale + self.offset
        if self.clamp:
            d = torch.clamp(d, 0.0, 1.0)
        return torch.where(mask, d, self.bg_value)


def _render_fused(
    mesh: TexturedMesh,
    cam: Camera,
    v_pos_clip: torch.Tensor,
    height: int,
    width: int,
    *,
    render_depth: bool,
    render_normal: bool,
    depth_normalization_strategy,
    normal_background,
    raster_config: RasterizerConfig,
    device: torch.device,
) -> RenderOutput:
    """Every requested channel rides attribute planes through one fused
    rasterization; world position is the unprojected depth plane."""
    nv = mesh.v_pos.shape[0]
    v_attr = None
    if render_normal:
        v_attr = mesh.v_nrm
        if v_attr is None or v_attr.shape[0] != nv:
            v_attr = compute_vertex_normals(mesh.v_pos, mesh.t_pos_idx)
    out = rasterize_gbuffer(
        v_pos_clip, mesh.t_pos_idx, v_attr, (height, width), raster_config,
        pos_world=mesh.v_pos, mvp=cam.mvp_mtx, device=device,
    )
    mask = out.mask

    # Unproject NDC (x, y, z) through the inverse MVP to world position
    # (fp32 on the card: resolve_device switched TF32 off).
    inv_mvp = torch.linalg.inv(cam.mvp_mtx)  # (B, 4, 4)
    px = (torch.arange(width, device=device, dtype=torch.float32) + 0.5) / width * 2.0 - 1.0
    py = (torch.arange(height, device=device, dtype=torch.float32) + 0.5) / height * 2.0 - 1.0
    ndc = torch.stack(
        [
            px[None, None, :].expand_as(out.z),
            py[None, :, None].expand_as(out.z),
            out.z,
            torch.ones_like(out.z),
        ],
        dim=-1,
    )  # (B, H, W, 4)
    world_h = torch.einsum("bhwj,bij->bhwi", ndc, inv_mvp)
    w = world_h[..., 3:4]
    w_div = torch.where(w.abs() < 1e-20, 1e-20, w)
    gb_pos = torch.where(mask[..., None], world_h[..., :3] / w_div, 0.0)
    res = {"mask": mask, "pos": gb_pos}

    if render_depth:
        gb_depth = -transform_points_homo(gb_pos, cam.w2c)[..., 2]
        b = gb_depth.shape[0]
        mn = torch.where(mask, gb_depth, float("inf")).reshape(b, -1).amin(dim=1)
        gb_depth = torch.where(mask, gb_depth, mn[:, None, None])
        if depth_normalization_strategy is not None:
            gb_depth = depth_normalization_strategy(gb_depth, mask)
        res["depth"] = gb_depth

    if render_normal:
        bg = torch.as_tensor(normal_background, dtype=torch.float32, device=device)
        res["normal"] = torch.where(mask[..., None], normalize(out.attr), bg)
    return RenderOutput(**res)


def _render_classic(
    mesh: TexturedMesh,
    cam: Camera,
    v_pos_clip: torch.Tensor,
    height: int,
    width: int,
    *,
    render_depth: bool,
    render_normal: bool,
    depth_normalization_strategy,
    normal_background,
    raster_config: RasterizerConfig,
    device: torch.device,
) -> RenderOutput:
    """The nvdiffrast-style branch: ``rasterize``, then every channel by
    ``interpolate`` (normals over the stitched topology)."""
    rast = rasterize(v_pos_clip, mesh.t_pos_idx, (height, width),
                     raster_config, device=device)
    mask = rast[..., 3] > 0
    gb_pos = interpolate(mesh.v_pos[None], rast, mesh.t_pos_idx, device=device)
    res = {"mask": mask, "pos": gb_pos}

    if render_depth:
        gb_depth = -transform_points_homo(gb_pos, cam.w2c)[..., 2]
        # Background pixels take the per-view minimum over every pixel,
        # background included, before normalization (as the JAX package's
        # classic branch does).
        b = gb_depth.shape[0]
        mn = gb_depth.reshape(b, -1).amin(dim=1)[:, None, None]
        gb_depth = torch.where(mask, gb_depth, mn)
        if depth_normalization_strategy is not None:
            gb_depth = depth_normalization_strategy(gb_depth, mask)
        res["depth"] = gb_depth

    if render_normal:
        gb_nrm = interpolate(mesh.v_nrm[None], rast, mesh.stitched_t_pos_idx,
                             device=device)
        bg = torch.as_tensor(normal_background, dtype=torch.float32, device=device)
        res["normal"] = torch.where(mask[..., None], normalize(gb_nrm), bg)
    return RenderOutput(**res)


def render(
    mesh: TexturedMesh,
    cam: Camera,
    height: int,
    width: int,
    render_attr: bool = True,
    render_depth: bool = True,
    render_normal: bool = True,
    render_tangent: bool = False,
    antialias_attr: bool = False,
    depth_normalization_strategy=DepthControlNetNormalization(),
    normal_background: Union[float, torch.Tensor] = 0.0,
    raster_config: RasterizerConfig = DEFAULT_CONFIG,
    ssaa: int = 1,
    view_chunk: int = 0,
    device: DeviceLike = None,
) -> RenderOutput:
    """Render per-view G-buffers on ``device`` (the card unless
    ``device="cpu"``; mesh and camera are moved there).

    Ported channels: mask, pos, depth (with its three normalizations) and
    normal, at any triangle count, through the fused branch or, for
    ``backend`` "xla", "pallas" or "vpu_pallas", the classic one. ``render_attr``
    (textured colour), ``render_tangent``, ``antialias_attr``, ``ssaa > 1``
    and ``view_chunk`` raise NotImplementedError until textures are ported
    (ROADMAP queue 1 item 5); pass ``render_attr=False``."""
    if render_attr or render_tangent or antialias_attr:
        raise NotImplementedError(
            "textured colour and tangents are not ported yet (ROADMAP queue 1 "
            "item 5); pass render_attr=False"
        )
    if ssaa != 1 or view_chunk:
        raise NotImplementedError(
            "ssaa and view_chunk are not ported yet (ROADMAP queue 1 item 5)"
        )
    dev = resolve_device(device)
    mesh = with_normals(mesh.to(dev))
    cam = cam.to(dev)
    v_pos_clip = get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    fused = raster_config.backend in ("auto", "fused_pallas", "fused_xla")
    branch = _render_fused if fused else _render_classic
    return branch(
        mesh, cam, v_pos_clip, height, width,
        render_depth=render_depth,
        render_normal=render_normal,
        depth_normalization_strategy=depth_normalization_strategy,
        normal_background=normal_background,
        raster_config=raster_config,
        device=dev,
    )
