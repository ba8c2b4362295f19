"""TexturePipeline: the texture-baking application of the PyTorch port
(counterpart of ``worldrenderer_tpu/pipelines/texture_pipeline.py``).

Optional UV unwrap, mesh load, cameras (the ORTHO six-view rig, CUSTOM
JSON or an override), per-modality (rgb / base_color / orm / normal)
projection with optional view upscaling, the normal map's rebake into the
mesh's UV tangent space, UV- or view-mode inpainting, the two Poisson
reprojection passes, GLB export. Every tensor step runs on the
pipeline's ``device`` (the card unless ``device="cpu"``).

The upscaler and the inpainter stay pluggable host callables (external
pretrained nets); the weightless fallbacks (cubic resize, diffusion
inpaint) keep the pipeline self-contained. Images are read with the
port's own PNG decoder; JPEG and WebP need Pillow.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..baking.projection import camera_projection
from ..baking.smart_paint import SmartPainter, default_inpaint_func
from ..baking.warp import resize_hw
from ..camera import Camera, get_camera, get_orthogonal_camera, normalize
from ..mesh import TexturedMesh, load_mesh
from ..ops.tensor import fma_dot3
from ..render import render
from ..scene.gltf import _PNG_SIGNATURE, _decode_png, replace_glb_texture, save_glb
from ..transforms import cross

__all__ = ["ModProcessConfig", "TexturePipeline", "TexturePipelineOutput"]

_IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".webp"}

# The fixed geometry tangent of each of the six ortho views; views beyond
# six take the first.
_ORTHO_BASE_TANGENTS = (
    (1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, -1, 0), (-1, 0, 0), (-1, 0, 0))


@dataclass
class ModProcessConfig:
    """Per-modality processing config."""

    view_upscale: bool = False
    view_upscale_factor: int = 2
    inpaint_mode: str = "uv"  # in ["none", "uv", "view"]
    view_inpaint_max_view_score_thresh: float = 0.02
    view_inpaint_min_rounds: int = 4
    view_inpaint_max_rounds: int = 8
    view_inpaint_uv_padding_end: bool = True


@dataclass
class TexturePipelineOutput:
    shaded_model_save_path: Optional[str] = None
    pbr_model_save_path: Optional[str] = None
    uv_proj_rgb: Optional[torch.Tensor] = None
    mesh_v_tex: Optional[torch.Tensor] = None
    mesh_t_tex_idx: Optional[torch.Tensor] = None


def _default_upscale(images: torch.Tensor, factor: int) -> torch.Tensor:
    """Weightless upscale fallback (stands in for a super-resolution net):
    ``jax.image.resize(method="cubic")``'s Keys cubic, clipped to [0, 1]."""
    _, h, w, _ = images.shape
    return resize_hw(images, h * factor, w * factor, "cubic").clamp(0.0, 1.0)


def _open_image(path: str) -> np.ndarray:
    """An image file as (H, W, 3) float32 in [0, 1], converted to RGB (gray
    repeated, alpha dropped, a palette looked up). PNG is decoded by the
    port; any other format needs Pillow."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        rgb = _decode_png(data)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"{path}: reading an image other than PNG needs "
                              "Pillow (the PIL module), which is not "
                              "installed") from e
        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
    return rgb.astype(np.float32) / 255.0


class TexturePipeline:
    """Bake multi-view modality images into mesh textures and export GLB."""

    def __init__(
        self,
        upscaler: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        inpainter: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
        raster_config=None,
        device: DeviceLike = None,
    ):
        from ..ops.rasterize import DEFAULT_CONFIG

        self.device = resolve_device(device)
        self.raster_config = raster_config or DEFAULT_CONFIG
        self.upscaler = upscaler
        self.inpainter = inpainter or default_inpaint_func
        self.smart_painter = SmartPainter(raster_config=self.raster_config)

    # -- image loading ------------------------------------------------------

    def load_packed_images(
        self, packed_image_path: Optional[str], num_views: Optional[int] = None
    ) -> Optional[np.ndarray]:
        """Directory / comma list / single packed-strip image loading.
        Returns (Nv, H, W, 3) float32 (host numpy)."""
        if packed_image_path is None:
            return None
        if os.path.isdir(packed_image_path):
            files = sorted(
                os.path.join(packed_image_path, f)
                for f in os.listdir(packed_image_path)
                if os.path.splitext(f)[1].lower() in _IMAGE_EXTS
            )
            images = [_open_image(f) for f in files]
        elif "," in packed_image_path:
            images = [
                _open_image(p.strip())
                for p in packed_image_path.split(",")
                if p.strip()
            ]
        else:
            images = [_open_image(packed_image_path)]

        if num_views is not None:
            if len(images) == 1 and num_views > 1:
                img = images[0]
                w = img.shape[1]
                if w % num_views == 0:
                    sw = w // num_views
                    images = [
                        img[:, i * sw : (i + 1) * sw] for i in range(num_views)
                    ]
                else:
                    raise ValueError(
                        f"Single image width {w} not divisible by "
                        f"num_views={num_views}; cannot split evenly."
                    )
            elif len(images) != num_views:
                raise ValueError(
                    f"Loaded {len(images)} images but expected {num_views}."
                )
        return np.stack(images, axis=0)

    def maybe_upscale_image(
        self, tensor: Optional[torch.Tensor], upscale: bool, factor: int
    ) -> Optional[torch.Tensor]:
        if not upscale or tensor is None:
            return tensor
        if self.upscaler is not None:
            return self.upscaler(tensor)
        return _default_upscale(tensor, factor)

    # -- normal-map rebake --------------------------------------------------

    def _rebake_normal(
        self, mod_tensor: torch.Tensor, mesh: TexturedMesh, cameras: Camera
    ) -> torch.Tensor:
        """World-space normal from the per-view geometry tangent frame, then
        rebaked into the mesh's UV tangent space. The two 3x3 products per
        pixel are fp32 FMA chains (``fma_dot3``), as the JAX package's fp32
        einsums round on the CPU."""
        nv, height, width, _ = mod_tensor.shape
        out = render(
            mesh,
            cameras,
            height,
            width,
            render_attr=False,
            render_depth=False,
            render_normal=True,
            render_tangent=True,
            raster_config=self.raster_config,
            device=self.device,
        )
        v_n = out.normal
        v_t = out.tangent
        v_b = cross(v_n, v_t)
        tang_space = normalize(torch.stack([v_t, v_b, v_n], dim=-2))

        base = _ORTHO_BASE_TANGENTS[:nv] + _ORTHO_BASE_TANGENTS[:1] * max(0, nv - 6)
        geo_t = torch.tensor(base, dtype=torch.float32, device=v_n.device)
        v_gn = v_n
        v_gb = cross(v_gn, geo_t[:, None, None, :])
        v_gt = cross(v_gb, v_gn)
        geo_tang_space = normalize(torch.stack([v_gt, v_gb, v_gn], dim=-2))

        m = mod_tensor * 2.0 - 1.0
        # world_j = sum_i m_i G[i, j]  (the rows of G are the basis vectors)
        world = normalize(fma_dot3(m[..., :, None], geo_tang_space, -2))
        # uv-tangent coords: uv_i = sum_j T[i, j] world_j
        uv_t = normalize(fma_dot3(tang_space, world[..., None, :], -1))
        return torch.clamp(uv_t * 0.5 + 0.5, 0.0, 1.0)

    # -- view inpainting ----------------------------------------------------

    def view_inpaint(
        self,
        mod_name: str,
        mesh: TexturedMesh,
        uv_proj: torch.Tensor,
        uv_valid_mask: torch.Tensor,
        config: ModProcessConfig,
        saver=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.smart_painter(
            mesh,
            self.inpainter,
            uv_proj,
            ~uv_valid_mask,
            max_view_score_thresh=config.view_inpaint_max_view_score_thresh,
            min_rounds=config.view_inpaint_min_rounds,
            max_rounds=config.view_inpaint_max_rounds,
            uv_padding_end=config.view_inpaint_uv_padding_end,
            saver=saver,
            mod_name=mod_name,
            device=self.device,
        )

    # -- main ---------------------------------------------------------------

    def __call__(
        self,
        mesh_path: str,
        save_dir: str,
        save_name: str = "default",
        move_to_center: bool = False,
        front_x: bool = False,
        keep_original_transform: bool = True,
        uv_unwarp: bool = False,
        preprocess_mesh: bool = False,
        uv_size: int = 4096,
        rgb_path: Optional[str] = None,
        rgb_tensor=None,
        rgb_process_config: ModProcessConfig = field(default_factory=ModProcessConfig),
        base_color_path: Optional[str] = None,
        base_color_process_config: Optional[ModProcessConfig] = None,
        orm_path: Optional[str] = None,
        orm_process_config: Optional[ModProcessConfig] = None,
        normal_path: Optional[str] = None,
        normal_strength: float = 1.0,
        normal_process_config: Optional[ModProcessConfig] = None,
        uv_inpaint_use_network: bool = False,
        view_inpaint_include_occlusion_boundary: bool = False,
        poisson_reprojection: bool = False,
        camera_projection_type: str = "ORTHO",  # "ORTHO" | "CUSTOM"
        # World-unit reprojection-validity bound forwarded to every
        # camera_projection call; "auto" for native-scale (unnormalized)
        # scenes (see baking.projection.camera_projection).
        pos_error_eps=1e-3,
        custom_camera_json: Optional[str] = None,
        cameras_override: Optional[Camera] = None,
        camera_elevation_deg: List[float] = (0, 0, 0, 0, 89.99, -89.99),
        camera_azimuth_deg: List[float] = (0, 90, 180, 270, 180, 180),
        camera_distance: float = 1.0,
        camera_ortho_scale: float = 1.1,
        camera_fov_deg: float = 40,
        debug_mode: bool = False,
    ) -> TexturePipelineOutput:
        dev = self.device
        os.makedirs(save_dir, exist_ok=True)
        saver = None
        if debug_mode:
            from ..utils.saving import SaverMixin

            saver = SaverMixin()
            saver.set_save_dir(os.path.join(save_dir, "debug"))

        if uv_unwarp:
            from ..meshproc import process_raw

            suffix = os.path.splitext(mesh_path)[-1]
            mesh_path_new = mesh_path.replace(suffix, f"_unwarp{suffix}")
            process_raw(mesh_path, mesh_path_new, preprocess=preprocess_mesh)
            mesh_path = mesh_path_new

        if not isinstance(rgb_process_config, ModProcessConfig):
            rgb_process_config = ModProcessConfig()
        base_color_process_config = base_color_process_config or ModProcessConfig()
        orm_process_config = orm_process_config or ModProcessConfig()
        normal_process_config = normal_process_config or ModProcessConfig()

        mesh = load_mesh(
            mesh_path,
            rescale=not keep_original_transform,
            move_to_center=False if keep_original_transform else move_to_center,
            front_x_to_y=False if keep_original_transform else front_x,
            default_uv_size=uv_size,
            device=dev,
        )

        cameras = None
        custom_cam_data = None
        if cameras_override is not None:
            cameras = cameras_override.to(dev)
            expected_views = len(cameras_override)
        elif camera_projection_type == "ORTHO":
            expected_views = 6
            cameras = get_orthogonal_camera(
                elevation_deg=np.asarray(camera_elevation_deg, np.float32),
                distance=np.full(6, camera_distance, np.float32),
                left=-camera_ortho_scale / 2,
                right=camera_ortho_scale / 2,
                bottom=-camera_ortho_scale / 2,
                top=camera_ortho_scale / 2,
                azimuth_deg=np.asarray(
                    [x - 90 for x in camera_azimuth_deg], np.float32
                ),  # -y as front
                device=dev,
            )
        elif camera_projection_type == "CUSTOM":
            if custom_camera_json is None:
                raise ValueError("CUSTOM camera requires custom_camera_json")
            with open(custom_camera_json) as f:
                custom_cam_data = json.load(f)
            expected_views = len(custom_cam_data)
        else:
            raise ValueError(
                f"Unsupported camera projection type: {camera_projection_type}"
            )

        mod_kwargs = {
            "rgb": (rgb_path, rgb_process_config),
            "base_color": (base_color_path, base_color_process_config),
            "orm": (orm_path, orm_process_config),
            "normal": (normal_path, normal_process_config),
        }
        mod_uv_tensor = {}
        for mod_name, (mod_path, cfg) in mod_kwargs.items():
            if mod_path is None:
                if mod_name == "rgb" and rgb_tensor is not None:
                    mod_tensor = torch.as_tensor(rgb_tensor, dtype=torch.float32,
                                                 device=dev)
                    if float(mod_tensor.max()) > 1.0:
                        mod_tensor = torch.clamp(mod_tensor / 255.0, 0.0, 1.0)
                else:
                    mod_uv_tensor[mod_name] = None
                    continue
            else:
                mod_tensor = torch.as_tensor(
                    self.load_packed_images(mod_path, num_views=expected_views),
                    device=dev,
                )
            mod_tensor = self.maybe_upscale_image(
                mod_tensor, cfg.view_upscale, cfg.view_upscale_factor
            )

            if cameras is None and custom_cam_data is not None:
                h, w = mod_tensor.shape[1:3]
                c2w = np.stack(
                    [
                        np.asarray(item["matrix_world"], np.float32)
                        for item in custom_cam_data
                    ]
                )
                fov = np.asarray(
                    [
                        float(item.get("fov_deg", camera_fov_deg))
                        for item in custom_cam_data
                    ],
                    np.float32,
                )
                cameras = get_camera(c2w=torch.from_numpy(c2w), fovy_deg=fov,
                                     aspect_wh=w / h, device=dev)

            nv = mod_tensor.shape[0]
            if mod_name == "normal":
                mod_tensor = self._rebake_normal(mod_tensor, mesh, cameras)
                out = camera_projection(
                    images=mod_tensor,
                    mesh=mesh,
                    cam=cameras,
                    from_scratch=cfg.inpaint_mode != "none",
                    poisson_blending=False,
                    depth_grad_dilation=5,
                    uv_exp_blend_alpha=3,
                    uv_exp_blend_view_weight=torch.ones(nv, device=dev),
                    aoi_cos_valid_threshold=0.2,
                    pos_error_eps=pos_error_eps,
                    uv_size=uv_size,
                    iou_rejection_threshold=None,
                    raster_config=self.raster_config,
                    device=dev,
                )
                uv_proj = torch.where(
                    out.uv_proj_mask[..., None],
                    out.uv_proj,
                    # flat tangent-space normal
                    torch.tensor([0.5, 0.5, 1.0], device=dev),
                )
            else:
                out = camera_projection(
                    images=mod_tensor,
                    mesh=mesh,
                    cam=cameras,
                    from_scratch=cfg.inpaint_mode != "none",
                    poisson_blending=False,
                    depth_grad_dilation=5,
                    depth_grad_threshold=None,
                    uv_exp_blend_alpha=3,
                    uv_exp_blend_view_weight=torch.ones(nv, device=dev),
                    aoi_cos_valid_threshold=-1.0,
                    pos_error_eps=pos_error_eps,
                    iou_rejection_threshold=None,
                    uv_size=uv_size,
                    uv_padding=not uv_inpaint_use_network,
                    raster_config=self.raster_config,
                    device=dev,
                )
                uv_proj = out.uv_proj
                uv_valid_mask = out.uv_proj_mask

                if uv_inpaint_use_network:
                    uv_proj = self.inpainter(uv_proj, 1.0 - uv_valid_mask.float())
                    if saver is not None:
                        saver.save_image_grid(
                            f"{mod_name}_uv_inpaint.jpg",
                            [out.uv_proj, uv_valid_mask, uv_proj],
                        )

                if cfg.inpaint_mode == "view":
                    if view_inpaint_include_occlusion_boundary:
                        uv_max_grad = out.uv_depth_grad.amax(dim=0)
                        uv_valid_mask = uv_valid_mask & (uv_max_grad < 0.1)
                    uv_proj, uv_valid_mask = self.view_inpaint(
                        mod_name, mesh, uv_proj, uv_valid_mask, cfg, saver=saver
                    )

                if poisson_reprojection and nv >= 5:
                    # Two Poisson passes: top / bottom, then front / sides /
                    # back.
                    for sl in (slice(4, min(6, nv)), slice(0, 4)):
                        res = camera_projection(
                            images=mod_tensor[sl],
                            mesh=mesh._replace(texture=uv_proj),
                            cam=cameras[sl],
                            from_scratch=False,
                            poisson_blending=True,
                            pb_keep_original_border=True,
                            depth_grad_dilation=5,
                            uv_exp_blend_alpha=3,
                            uv_exp_blend_view_weight=torch.ones(
                                mod_tensor[sl].shape[0], device=dev
                            ),
                            aoi_cos_valid_threshold=0.2,
                            uv_size=uv_size,
                            uv_padding=True,
                            iou_rejection_threshold=None,
                            raster_config=self.raster_config,
                            device=dev,
                        )
                        if res is not None:
                            uv_proj = res.uv_proj

                if mod_name == "orm":
                    uv_proj = uv_proj.clone()
                    uv_proj[:, :, 0] = 1.0

            mod_uv_tensor[mod_name] = uv_proj

        def host(x):
            return x.detach().cpu().numpy()

        def _save(path, texture, **extra_tex):
            if mesh_path.endswith((".glb", ".gltf")) and not extra_tex:
                try:
                    replace_glb_texture(mesh_path, path, host(texture))
                    return
                except ValueError:
                    pass  # source had no texture slot; write a fresh GLB
            save_glb(
                path,
                vertices=host(mesh.v_pos),
                faces=host(mesh.t_pos_idx),
                uv=host(mesh.v_tex) if mesh.v_tex is not None else None,
                texture=host(texture),
                **extra_tex,
            )

        shaded_model_save_path = None
        if mod_uv_tensor.get("rgb") is not None:
            shaded_model_save_path = os.path.join(save_dir, f"{save_name}_shaded.glb")
            _save(shaded_model_save_path, mod_uv_tensor["rgb"])
        pbr_model_save_path = None
        if mod_uv_tensor.get("base_color") is not None:
            pbr_model_save_path = os.path.join(save_dir, f"{save_name}_pbr.glb")
            extra = {}
            if mod_uv_tensor.get("orm") is not None:
                extra["metallic_roughness_texture"] = host(mod_uv_tensor["orm"])
            if mod_uv_tensor.get("normal") is not None:
                extra["normal_texture"] = host(mod_uv_tensor["normal"])
            _save(pbr_model_save_path, mod_uv_tensor["base_color"], **extra)

        return TexturePipelineOutput(
            shaded_model_save_path=shaded_model_save_path,
            pbr_model_save_path=pbr_model_save_path,
            uv_proj_rgb=mod_uv_tensor.get("rgb"),
            mesh_v_tex=mesh.v_tex,
            mesh_t_tex_idx=mesh.t_tex_idx,
        )
