"""G-buffer rendering: mask / position / depth / textured colour / normal /
tangent maps for a batch of views (PyTorch counterpart of
``worldrenderer_tpu/render.py``).

The fused branch (``backend`` "auto", "fused_pallas" or "fused_xla")
rasterizes every channel as attribute planes in one pass, (u, v) among
them, and samples the texture at the interpolated (u, v); every other
backend takes the classic branch, ``rasterize`` then ``interpolate``, as the
JAX package's ``render`` routes them (so ``"vpu_pallas"`` reaches kernel K3
through ``rasterize_gbuffer``, not through ``render``). Split-UV meshes take
the fused branch under "auto" after a cached seam cut
(``mesh.unify_mesh_uv``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .camera import Camera, normalize
from .mesh import (
    TexturedMesh,
    _unify_cached,
    compute_vertex_normals,
    is_registered_quantized_texture,
    with_normals,
)
from .ops.antialias import antialias
from .ops.gbuffer import rasterize_gbuffer
from .ops.interpolate import interpolate
from .ops.rasterize import DEFAULT_CONFIG, RasterizerConfig, rasterize
from .ops.texture import texture
from .transforms import (get_clip_space_position, inverse_f32,
                         transform_points_homo)

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


def _fd_uv_da(tex_c: torch.Tensor) -> torch.Tensor:
    """Screen-space uv footprint by forward differences of the per-pixel
    (u, v) image, channels (du/dX, du/dY, dv/dX, dv/dY), for the mip level
    of ``texture_filter_mode="auto_mip"``. Across triangle and background
    edges it is wrong, which only moves the mip level of edge pixels."""
    du_dx = torch.diff(tex_c, dim=2, append=tex_c[:, :, -1:])
    du_dy = torch.diff(tex_c, dim=1, append=tex_c[:, -1:])
    return torch.cat([du_dx[..., 0:1], du_dy[..., 0:1], du_dx[..., 1:2],
                      du_dy[..., 1:2]], dim=-1)


def _bg(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def _sample_attr(tex_c, mask, tex, *, texture_filter_mode, texture_gather_mode,
                 texture_pack_mode, attr_background, device):
    """The texture sampled at the (u, v) image, background where ``mask``
    is False."""
    if texture_filter_mode == "auto_mip":
        fg = texture(tex[None], tex_c, uv_da=_fd_uv_da(tex_c), filter_mode="auto",
                     pack_mode=texture_pack_mode, device=device)
    else:
        fg = texture(tex[None], tex_c, filter_mode=texture_filter_mode,
                     gather_mode=texture_gather_mode, pack_mode=texture_pack_mode,
                     device=device)
    bg = torch.ones_like(fg) * _bg(attr_background, fg.device)
    return torch.where(mask[..., None], fg, bg)


def _depth_channel(gb_pos, mask, cam, depth_normalization_strategy, fg_min):
    """View-space depth; background takes the per-view minimum (over the
    foreground for the fused branch, over every pixel for the classic one,
    as the JAX package's two branches do) before normalization."""
    gb_depth = -transform_points_homo(gb_pos, cam.w2c)[..., 2]
    b = gb_depth.shape[0]
    src = torch.where(mask, gb_depth, float("inf")) if fg_min else gb_depth
    mn = src.reshape(b, -1).amin(dim=1)[:, None, None]
    gb_depth = torch.where(mask, gb_depth, mn)
    if depth_normalization_strategy is not None:
        gb_depth = depth_normalization_strategy(gb_depth, mask)
    return gb_depth


def _render_fused(mesh, cam, v_pos_clip, height, width, *, render_attr,
                  render_depth, render_normal, render_tangent, antialias_attr,
                  depth_normalization_strategy, normal_background,
                  tangent_background, tex_kw, raster_config, device):
    """Every requested channel rides attribute planes through one fused
    rasterization (normal, tangent and (u, v) over the primary topology);
    world position is the unprojected depth plane."""
    # The unprojection's inverse MVPs and pixel centres come from the host
    # (the inverse in the JAX package's LAPACK rounding order, and the card
    # divides by a scalar as a multiply by its reciprocal), made before the
    # rasterizer is queued: a copy between host and card waits for the work
    # queued before it.
    inv_mvp = inverse_f32(cam.mvp_mtx).to(device)  # (B, 4, 4)
    px = ((torch.arange(width, dtype=torch.float32) + 0.5) / width * 2.0 - 1.0).to(device)
    py = ((torch.arange(height, dtype=torch.float32) + 0.5) / height * 2.0 - 1.0).to(device)
    nv = mesh.v_pos.shape[0]
    channels, slices, at = [], {}, 0
    if render_normal:
        v_nrm = mesh.v_nrm
        if v_nrm is None or v_nrm.shape[0] != nv:
            v_nrm = compute_vertex_normals(mesh.v_pos, mesh.t_pos_idx)
        channels.append(v_nrm)
        slices["normal"] = (at, at + 3)
        at += 3
    if render_tangent:
        if mesh.v_tang is None or mesh.v_tang.shape[0] != nv:
            raise ValueError("fused path needs per-primary-vertex tangents")
        channels.append(mesh.v_tang)
        slices["tangent"] = (at, at + 3)
        at += 3
    sample_uv = render_attr and mesh.v_tex is not None and mesh.v_tex.shape[0] == nv
    if render_attr and not sample_uv:
        raise ValueError(
            "fused path requires per-primary-vertex UVs for attr rendering; "
            "use the classic backend for split UV topologies")
    if sample_uv:
        channels.append(mesh.v_tex)
        slices["uv"] = (at, at + 2)
        at += 2
    v_attr = torch.cat(channels, dim=-1) if channels else None
    out = rasterize_gbuffer(
        v_pos_clip, mesh.t_pos_idx, v_attr, (height, width), raster_config,
        pos_world=mesh.v_pos, mvp=cam.mvp_mtx, device=device,
    )
    mask = out.mask

    # Unproject NDC (x, y, z, 1) through the inverse MVP to world position,
    # rounded as the JAX package's HIGHEST einsum on the CPU: each product
    # rounded, then (x m0 + y m1) + (z m2 + m3). Each op is a kernel of its
    # own, so the card rounds as the CPU does (nothing fuses into an FMA).
    cols = inv_mvp[:, None, None]  # (B, 1, 1, 4 i, 4 j)
    world_h = ((px[:, None] * cols[..., 0] + py[:, None, None] * cols[..., 1])
               + (out.z[..., None] * cols[..., 2] + cols[..., 3]))  # (B, H, W, 4)
    w = world_h[..., 3:4]
    w_div = torch.where(w.abs() < 1e-20, 1e-20, w)
    gb_pos = torch.where(mask[..., None], world_h[..., :3] / w_div, 0.0)
    res = {"mask": mask, "pos": gb_pos}

    if render_depth:
        res["depth"] = _depth_channel(gb_pos, mask, cam,
                                      depth_normalization_strategy, True)
    for name, bg in (("normal", normal_background),
                     ("tangent", tangent_background)):
        if name in slices:
            a0, a1 = slices[name]
            res[name] = torch.where(mask[..., None], normalize(out.attr[..., a0:a1]),
                                    _bg(bg, device))
    if sample_uv:
        a0, a1 = slices["uv"]
        gb_rgb = _sample_attr(out.attr[..., a0:a1], mask, **tex_kw)
        if antialias_attr:
            z = out.z[..., None]
            rast_like = torch.cat([torch.zeros_like(z), torch.zeros_like(z), z,
                                   out.tri_id.to(torch.float32)[..., None]], dim=-1)
            gb_rgb = antialias(gb_rgb, rast_like, v_pos_clip, mesh.t_pos_idx,
                               device=device)
        res["attr"] = gb_rgb
    return RenderOutput(**res)


def _render_classic(mesh, cam, v_pos_clip, height, width, *, render_attr,
                    render_depth, render_normal, render_tangent, antialias_attr,
                    depth_normalization_strategy, normal_background,
                    tangent_background, tex_kw, raster_config, device):
    """The nvdiffrast-style branch: ``rasterize``, then every channel by
    ``interpolate`` (uv over ``t_tex_idx``, normals and tangents over the
    stitched topology)."""
    rast = rasterize(v_pos_clip, mesh.t_pos_idx, (height, width),
                     raster_config, device=device)
    mask = rast[..., 3] > 0
    gb_pos = interpolate(mesh.v_pos[None], rast, mesh.t_pos_idx, device=device)
    res = {"mask": mask, "pos": gb_pos}
    if render_depth:
        res["depth"] = _depth_channel(gb_pos, mask, cam,
                                      depth_normalization_strategy, False)
    if render_attr:
        tex_c = interpolate(mesh.v_tex[None], rast, mesh.t_tex_idx, device=device)
        gb_rgb = _sample_attr(tex_c, mask, **tex_kw)
        if antialias_attr:
            gb_rgb = antialias(gb_rgb, rast, v_pos_clip, mesh.t_pos_idx,
                               device=device)
        res["attr"] = gb_rgb
    for name, on, vals, bg in (
            ("normal", render_normal, mesh.v_nrm, normal_background),
            ("tangent", render_tangent, mesh.v_tang, tangent_background)):
        if on:
            g = interpolate(vals[None], rast, mesh.stitched_t_pos_idx, device=device)
            res[name] = torch.where(mask[..., None], normalize(g), _bg(bg, device))
    return RenderOutput(**res)


def _is_k255(tex: torch.Tensor) -> bool:
    """Every texel within 1e-6 of some k/255 in [0, 1] (read on the host;
    the caller passes only CPU tensors)."""
    a = tex.detach().double().numpy()
    if not a.size or a.min() < 0.0 or a.max() > 1.0:
        return False
    return bool(np.abs(a - np.round(a * 255.0) / 255.0).max() <= 1e-6)


def _auto_pack_mode(tex, render_attr: bool, texture_filter_mode: str) -> str:
    """``texture_pack_mode="auto"``: "u8" for a texture of at least 512²
    texels that is registered as 255-quantized, or that lies on the CPU and
    is k/255 to within 1e-6; else "none". A CUDA tensor is never copied
    back to be inspected, and ``auto_mip`` never upgrades (the packed mip
    chain re-quantizes every level)."""
    if not (render_attr and texture_filter_mode != "auto_mip"
            and isinstance(tex, torch.Tensor) and tex.ndim >= 2
            and tex.shape[0] * tex.shape[1] >= 512 * 512):
        return "none"
    if is_registered_quantized_texture(tex) or (
            tex.device.type == "cpu" and _is_k255(tex)):
        return "u8"
    return "none"


def _down(x: Optional[torch.Tensor], height: int, width: int, s: int):
    """Box-filter an (s*H, s*W) channel to (H, W); a boolean mask becomes
    float coverage."""
    if x is None:
        return None
    b = x.shape[0]
    if x.ndim == 3:
        return x.float().reshape(b, height, s, width, s).mean((2, 4))
    return x.reshape(b, height, s, width, s, x.shape[-1]).mean((2, 4))


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
    attr_background: Union[float, torch.Tensor] = 0.5,
    normal_background: Union[float, torch.Tensor] = 0.0,
    tangent_background: Union[float, torch.Tensor] = 0.0,
    texture_override: Optional[torch.Tensor] = None,
    texture_filter_mode: str = "linear",
    texture_gather_mode: str = "vmap",
    texture_pack_mode: str = "auto",
    raster_config: RasterizerConfig = DEFAULT_CONFIG,
    ssaa: int = 1,
    view_chunk: int = 0,
    device: DeviceLike = None,
) -> RenderOutput:
    """Render per-view G-buffers on ``device`` (the card unless
    ``device="cpu"``; mesh, camera and texture are moved there).

    ``texture_pack_mode="auto"`` picks "u8" (bit-identical for k/255
    texels) for a registered or host-checked quantized texture of at least
    512² texels. ``view_chunk``: render the views in chunks of this size
    (it must divide the view count) and concatenate. ``ssaa``: render at
    (ssaa*H, ssaa*W) and box-filter every channel; ``mask`` becomes float
    coverage and normals / tangents are not re-normalized (size a tuned
    ``raster_config`` for the supersampled resolution).

    Split-UV meshes under ``backend="auto"`` are seam-cut once per mesh
    (cached on the caller's tensors) and take the fused branch."""
    tex = texture_override if texture_override is not None else mesh.texture
    if texture_pack_mode == "auto":
        texture_pack_mode = _auto_pack_mode(tex, render_attr, texture_filter_mode)
    kw = dict(
        render_attr=render_attr, render_depth=render_depth,
        render_normal=render_normal, render_tangent=render_tangent,
        antialias_attr=antialias_attr,
        depth_normalization_strategy=depth_normalization_strategy,
        attr_background=attr_background, normal_background=normal_background,
        tangent_background=tangent_background,
        texture_override=texture_override,
        texture_filter_mode=texture_filter_mode,
        texture_gather_mode=texture_gather_mode,
        texture_pack_mode=texture_pack_mode, raster_config=raster_config,
        device=device,
    )
    n_views = len(cam)
    if view_chunk and 0 < view_chunk < n_views:
        if n_views % view_chunk:
            raise ValueError(f"view_chunk {view_chunk} must divide the view "
                             f"count {n_views}")
        outs = [render(mesh, cam[i:i + view_chunk], height, width, ssaa=ssaa, **kw)
                for i in range(0, n_views, view_chunk)]
        return RenderOutput(*(
            None if parts[0] is None else torch.cat(parts, dim=0)
            for parts in zip(*outs)))
    if ssaa > 1:
        out = render(mesh, cam, height * ssaa, width * ssaa, **kw)
        return RenderOutput(*(_down(x, height, width, ssaa) for x in out))

    if (raster_config.backend == "auto" and render_attr
            and mesh.v_tex is not None
            and mesh.v_tex.shape[0] != mesh.v_pos.shape[0]):
        mesh = _unify_cached(mesh)
    dev = resolve_device(device)
    mesh = with_normals(mesh.to(dev), compute_tangents=render_tangent)
    cam = cam.to(dev)
    v_pos_clip = get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    fused = raster_config.backend in ("auto", "fused_pallas", "fused_xla")
    branch = _render_fused if fused else _render_classic
    tex_kw = dict(
        tex=None if tex is None else tex.to(dev),
        texture_filter_mode=texture_filter_mode,
        texture_gather_mode=texture_gather_mode,
        texture_pack_mode=texture_pack_mode,
        attr_background=attr_background,
        device=dev,
    )
    return branch(
        mesh, cam, v_pos_clip, height, width,
        render_attr=render_attr, render_depth=render_depth,
        render_normal=render_normal, render_tangent=render_tangent,
        antialias_attr=antialias_attr,
        depth_normalization_strategy=depth_normalization_strategy,
        normal_background=normal_background,
        tangent_background=tangent_background, tex_kw=tex_kw,
        raster_config=raster_config, device=dev,
    )
