"""SmartPainter: iterative view-based texture inpainting (PyTorch
counterpart of ``worldrenderer_tpu/baking/smart_paint.py``).

Each round renders a coverage "score map" texture from a rig of 108 anchor
cameras, picks the worst-covered view, renders it at high resolution,
builds an inpaint mask (shrink, enlarge, minus occlusion boundaries), runs
a pluggable inpainting function, projects the result back into UV space
and updates the score map; the loop stops when the worst view's score
falls under a threshold. The loop is driven from the host: each round
reads the 108 view scores once. Everything else in a round runs on the
device of the call (the card unless ``device="cpu"``).
"""

from __future__ import annotations

from itertools import product
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..camera import Camera, get_camera, normalize
from ..mesh import TexturedMesh
from ..ops.image import batch_dilate, batch_erode, inpaint, sobel_grad_magnitude
from ..ops.rasterize import DEFAULT_CONFIG
from ..ops.tensor import fma_dot3
from ..render import render
from .projection import camera_projection
from .uv import uv_padding

__all__ = ["SmartPainter", "default_inpaint_func"]


def default_inpaint_func(image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Weightless inpainter: diffuse the known pixels of (H, W, C)
    ``image`` into the (H, W) ``mask`` (64 steps), on the image's device.
    It stands in for a neural inpainter."""
    return inpaint(image, mask > 0.5, radius=64, device=image.device)


def _view_aoi_cos(render_out, cam: Camera) -> torch.Tensor:
    """Camera-space normal z clipped to [0, 1], 0 outside the mask. The
    rotation is the reference's fp32 einsum as a chain of FMAs (as
    ``uv.uv_view_geometry`` rounds it), never a TF32 matmul."""
    rot = cam.w2c[:, None, None, :3, :3]  # (B, 1, 1, 3 i, 3 j)
    n_cs = normalize(fma_dot3(render_out.normal[..., None, :], rot, -1))
    n_cs = torch.where(render_out.mask[..., None], n_cs, 0.0)
    return torch.clamp(n_cs[..., 2], 0.0, 1.0)


def _shrink_mask(mask: torch.Tensor, radius: int) -> torch.Tensor:
    return batch_erode(mask[None].float(), 2 * radius + 1,
                       device=mask.device)[0] > 0.5


def _enlarge_mask(mask: torch.Tensor, radius: int) -> torch.Tensor:
    return batch_dilate(mask[None].float(), 2 * radius + 1,
                        device=mask.device)[0] > 0.5


def _occlusion_boundary(view_depth: torch.Tensor, dilation: int,
                        thresh: float) -> torch.Tensor:
    grad = sobel_grad_magnitude(view_depth[None], device=view_depth.device)[0]
    occ = grad > thresh
    if dilation > 0:
        occ = _enlarge_mask(occ, dilation)
    return occ


def _make_view_selection_cams(generator: Optional[torch.Generator] = None,
                              device: DeviceLike = None) -> Camera:
    """The anchor rig: 9 elevations (-60 to 60 by 15) x 12 azimuths (0 to
    330 by 30) at distance 1.2 and fovy 40, positions jittered by uniform
    noise in [-0.1, 0.1] from ``generator`` (``get_camera``'s default
    seed without one)."""
    params = list(product(range(-60, 61, 15), range(0, 360, 30), [1.2], [40]))
    elevation, azimuth, distance, fovy = (list(p) for p in zip(*params))
    return get_camera(
        elevation_deg=np.asarray(elevation, np.float32),
        azimuth_deg=np.asarray(azimuth, np.float32),
        distance=np.asarray(distance, np.float32),
        fovy_deg=np.asarray(fovy, np.float32),
        perturb_camera_position=0.1,
        generator=generator,
        device=device,
    )


def _sum_hw(x: torch.Tensor) -> torch.Tensor:
    """Per-view sum over (H, W) of fp32 values: accumulated in float64 and
    rounded once, so the CPU and the card agree whatever order each
    reduces in."""
    return x.double().sum(dim=(1, 2)).float()


class SmartPainter:
    """The iterative worst-view inpainting loop. ``history`` holds, per
    round of the last call, the 108 view scores and the chosen view."""

    def __init__(self, raster_config=None):
        self.raster_config = raster_config or DEFAULT_CONFIG
        self.history = []

    def __call__(
        self,
        mesh: TexturedMesh,
        inpaint_func: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        uv_texture,
        uv_inpaint_mask,
        max_view_score_thresh: float = 0.02,
        min_rounds: int = 3,
        max_rounds: int = 8,
        uv_padding_end: bool = True,
        score_render_size: int = 256,
        inpaint_render_size: int = 1024,
        generator: Optional[torch.Generator] = None,
        saver=None,
        mod_name: str = "mod",
        device: DeviceLike = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (texture, covered_mask) on ``device`` (the card unless
        ``device="cpu"``). ``inpaint_func`` maps ((H, W, C) image, (H, W)
        float mask) -> (H, W, C) image; ``generator`` jitters the anchor
        rig."""
        dev = resolve_device(device)
        cfg = self.raster_config
        mesh = mesh.to(dev)
        cams = _make_view_selection_cams(generator, device=dev)

        texture_update = torch.as_tensor(uv_texture, dtype=torch.float32, device=dev)
        uv_valid_mask_update = ~torch.as_tensor(uv_inpaint_mask, device=dev).bool()
        score_map_update = uv_valid_mask_update.float()
        n_pix = torch.tensor(float(score_render_size ** 2), device=dev)

        self.history = []
        max_view_score = 1.0
        i = 0
        while i < min_rounds or (max_view_score > max_view_score_thresh
                                 and i < max_rounds):
            score_map_image = score_map_update[:, :, None].repeat(1, 1, 3)
            out = render(mesh, cams, score_render_size, score_render_size,
                         attr_background=1.0, texture_override=score_map_image,
                         texture_filter_mode="nearest", render_depth=False,
                         raster_config=cfg, device=dev)
            aoi = _view_aoi_cos(out, cams)
            attr0 = out.attr[..., 0]
            # Score = uncovered area + aoi-weighted under-coverage.
            uncovered = ((attr0 < 1e-3) & (aoi > 0.1)).sum(dim=(1, 2))
            weighted = _sum_hw(((attr0 > 1e-3) & (aoi > 0.1)).float()
                               * torch.clamp(aoi - attr0 - 0.3, min=0.0))
            view_score = ((uncovered.float() + weighted) / n_pix).cpu().numpy()
            max_view_score = float(view_score.max())
            best_view = int(view_score.argmax())  # the first of equal maxima
            self.history.append({"view_scores": view_score, "best_view": best_view})
            best_cam = cams[best_view]

            out_hi = render(mesh, best_cam, inpaint_render_size,
                            inpaint_render_size, attr_background=1.0,
                            texture_override=score_map_image,
                            texture_filter_mode="nearest", raster_config=cfg,
                            device=dev)
            aoi_hi = _view_aoi_cos(out_hi, best_cam)
            inpaint_mask = ((out_hi.attr[0, :, :, 0] < 1e-3)
                            | (aoi_hi[0] - out_hi.attr[0, :, :, 0] > 0.3))
            occ = _occlusion_boundary(out_hi.depth[0], dilation=0, thresh=0.1)
            # shrink (UV-seam speckle) -> enlarge (context) -> minus the
            # occlusion boundary (bleeding)
            inpaint_mask = _enlarge_mask(_shrink_mask(inpaint_mask, 3), 5) & ~occ

            inpaint_image = render(mesh, best_cam, inpaint_render_size,
                                   inpaint_render_size,
                                   texture_override=texture_update,
                                   texture_filter_mode="linear",
                                   render_depth=False, render_normal=False,
                                   raster_config=cfg, device=dev).attr[0]
            inpaint_result = torch.as_tensor(
                inpaint_func(inpaint_image, inpaint_mask.float()),
                dtype=torch.float32, device=dev)
            if saver is not None:
                saver.save_image_grid(
                    f"{mod_name}_inpaint_result_{i:02d}.jpg",
                    [inpaint_image, inpaint_mask, inpaint_result], rows=1)

            proj = camera_projection(
                images=inpaint_result[None],
                mesh=mesh._replace(texture=texture_update),
                cam=best_cam,
                masks=inpaint_mask[None].float(),
                from_scratch=False,
                poisson_blending=False,
                depth_grad_dilation=3,
                uv_exp_blend_alpha=3,
                aoi_cos_valid_threshold=0.1,
                uv_size=texture_update.shape[0],
                uv_padding=True,
                iou_rejection_threshold=None,
                raster_config=cfg,
                device=dev,
            )
            texture_update = proj.uv_proj
            uv_valid_mask_update = proj.uv_proj_mask | uv_valid_mask_update
            score_map_inpaint = torch.where(proj.uv_proj_mask,
                                            proj.uv_aoi_cos[0], 0.0)
            score_map_update = torch.maximum(score_map_update, score_map_inpaint)
            i += 1

        if uv_padding_end:
            texture_update = uv_padding(texture_update, uv_valid_mask_update, 3,
                                        device=dev)
        return texture_update, uv_valid_mask_update
