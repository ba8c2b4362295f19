"""The main application of the PyTorch port: blend / GLB -> cameras ->
project video onto the mesh -> bake the texture -> re-render rgb / 16-bit
depth / normal / mask frame sequences (counterpart of
``worldrenderer_tpu/pipelines/project_render.py``).

One batched render over the whole camera trajectory, chunked by
``render_chunk`` views, on ``device`` (the card unless the caller passes
``device="cpu"``; the CLI's ``--device`` defaults to ``cuda``). The frames
move to the device once; each written sequence takes one host copy and is
encoded with the port's own PNG codec. Reading the footage needs OpenCV.

    python -m worldrenderer_tpu_torch.pipelines.project_render \\
        --blend-path scene.glb --camera-json camera.json \\
        --video-path footage.mp4 --output-dir out --device cuda
"""

from __future__ import annotations

import argparse
import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..camera import Camera
from ..mesh import TexturedMesh, load_mesh
from ..ops.tensor import chunk_batch
from ..render import SimpleNormalization, render
from ..scene.blender import export_blend_to_glb, export_camera_json
from ..scene.camera_json import load_camera_from_json
from ..scene.gltf import _encode_png
from ..scene.video import _to_uint8, load_frames, save_depth_frames_16bit, save_frames
from .texture_pipeline import ModProcessConfig, TexturePipeline

__all__ = ["project_and_render", "main"]


def _auto_near_far(mesh: TexturedMesh, cam: Camera, near0: float, far0: float):
    """Near / far from the mesh <-> camera distance span with 5% padding;
    ``(near0, far0)`` when the cameras have no c2w or the mesh no vertex.
    The vertices and camera positions are copied to the host. (The JAX
    package's ``project_and_render`` computes it and never reads it;
    ``project_and_render`` here does not call it.)"""
    if cam.c2w is None or mesh.v_pos.shape[0] == 0:
        return near0, far0
    cam_pos = cam.c2w[:, :3, 3].detach().cpu().numpy()
    v = mesh.v_pos.detach().cpu().numpy()[None]
    dist = np.linalg.norm(v - cam_pos[:, None, :], axis=-1)
    min_d, max_d = float(dist.min()), float(dist.max())
    span = max_d - min_d
    pad = span * 0.05 if span > 0 else 1.0
    near = max(1e-4, min_d - pad)
    far = max(near + 1e-4, max_d + pad)
    return near, far


def project_and_render(
    mesh_path,
    video_path,
    output_dir,
    height: Optional[int] = None,
    width: Optional[int] = None,
    blender_bin: str = "blender",
    uv_size: int = 2048,
    frame_step: int = 1,
    max_frames: int = 0,
    camera_json=None,
    next_camera_json=None,
    axis_convert: bool = False,
    uv_unwarp: bool = True,
    render_chunk: int = 16,
    keyframe_selection: bool = False,
    keyframe_t_position: float = 0.20,
    keyframe_t_rotation: float = 0.5,
    debug: bool = False,
    raster: str = "exact",
    pos_error_eps=1e-3,
    device: DeviceLike = None,
) -> None:
    """``raster='fast'`` sizes the fast path's binning budgets to this
    scene's cameras (``auto_fast_config``: exact span histogram + headroom
    + lossless validation) before rendering; 'exact' keeps the default
    always-exact configuration."""
    dev = resolve_device(device)
    mesh_path = Path(mesh_path)
    output_dir = Path(output_dir)
    if output_dir.exists():
        shutil.rmtree(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    ifproject = video_path is not None
    if mesh_path.suffix == ".blend":
        glb_path = mesh_path.with_suffix(".glb")
        if camera_json is None:
            camera_json = output_dir / "camera.json"
            export_camera_json(mesh_path, camera_json, blender_bin)
        export_blend_to_glb(mesh_path, glb_path, blender_bin)
    else:
        glb_path = mesh_path
        if camera_json is None or not Path(camera_json).exists():
            raise ValueError(
                "non-.blend input requires camera_json "
                "(pass a .blend for automatic export)"
            )
    camera_json = Path(camera_json)

    video_h, video_w = height or 512, width or 512
    num_views_all = max_frames if max_frames > 0 else 1
    frames_np = None
    if ifproject:
        frames_np = load_frames(video_path, 0, frame_step, max_frames)
        num_views_all, video_h, video_w = frames_np.shape[:3]

    cam_all, _, _ = load_camera_from_json(
        camera_json, video_h, video_w,
        max_views=max_frames if max_frames > 0 else 10**9,
        axis_convert=axis_convert, device=dev,
    )
    num_views = min(num_views_all, len(cam_all))
    cam = cam_all[:num_views]

    if keyframe_selection:
        # Project from keyframes only; rendering below still follows the
        # full / next trajectory.
        from ..scene.keyframe import get_keyframes

        key_idx = [
            int(i)
            for i in get_keyframes(
                camera_json, num_views,
                t_position=keyframe_t_position, t_rotation=keyframe_t_rotation,
            )
            if 0 <= int(i) < num_views
        ]
        if not key_idx:
            raise RuntimeError("No valid keyframes found within camera range.")
        cam = cam_all[key_idx]
        if ifproject:
            frames_np = frames_np[key_idx]
        num_views = len(key_idx)

    tp = TexturePipeline(device=dev)
    if ifproject:
        frames_np = frames_np[:num_views]
        tp_out = tp(
            mesh_path=str(glb_path),
            save_dir=str(output_dir),
            save_name="projected",
            keep_original_transform=True,
            uv_size=uv_size,
            uv_unwarp=uv_unwarp,
            rgb_tensor=torch.as_tensor(frames_np, device=dev),
            rgb_process_config=ModProcessConfig(inpaint_mode="uv"),
            camera_projection_type="CUSTOM",
            cameras_override=cam,
            debug_mode=debug,
            pos_error_eps=pos_error_eps,
        )
        mesh = load_mesh(
            tp_out.shaded_model_save_path or str(glb_path),
            default_uv_size=uv_size,
            merge_vertices=True,
            device=dev,
        )
        if tp_out.uv_proj_rgb is None:
            raise RuntimeError("TexturePipeline returned no RGB UV projection.")
        # The projection-time texture and UVs, so that the re-render samples
        # what was baked.
        mesh = mesh._replace(texture=tp_out.uv_proj_rgb)
        if tp_out.mesh_v_tex is not None:
            mesh = mesh._replace(
                v_tex=tp_out.mesh_v_tex, t_tex_idx=tp_out.mesh_t_tex_idx
            )
        if debug:
            dbg = output_dir / "debug"
            dbg.mkdir(parents=True, exist_ok=True)
            (dbg / "uv_proj.png").write_bytes(_encode_png(
                _to_uint8(tp_out.uv_proj_rgb.detach().cpu().numpy())))
    else:
        path = str(glb_path)
        if uv_unwarp:
            from ..meshproc import process_raw

            suffix = os.path.splitext(path)[-1]
            path_new = path.replace(suffix, f"_unwarp{suffix}")
            process_raw(path, path_new, preprocess=False)
            path = path_new
        mesh = load_mesh(path, default_uv_size=uv_size, merge_vertices=True,
                         device=dev)

    # The JAX package computes _auto_near_far's span here and then renders
    # with the camera JSON's own near / far: the result is unused, so the
    # port does not pay for its host copies.

    # mm-scale 16-bit depth normalization.
    norm_range = 65.535
    depth_norm = SimpleNormalization(
        scale=1.0 / norm_range, offset=0.0, clamp=True, bg_value=1.0
    )

    if next_camera_json is not None and Path(next_camera_json).exists():
        cam_all, _, _ = load_camera_from_json(
            next_camera_json, video_h, video_w,
            max_views=num_views_all, axis_convert=axis_convert, device=dev,
        )
        cam = cam_all[:num_views]

    out_h = height or video_h
    out_w = width or video_w

    from ..ops.rasterize import DEFAULT_CONFIG

    raster_config = DEFAULT_CONFIG
    if raster == "fast":
        from ..ops.rasterize import FAST_TPU_CONFIG, auto_fast_config
        from ..transforms import get_clip_space_position

        pos_clip = get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
        raster_config = auto_fast_config(
            pos_clip, mesh.t_pos_idx, (out_h, out_w), base=FAST_TPU_CONFIG
        )

    def render_batch(c2w, w2c, proj_mtx, mvp_mtx, cam_pos):
        batch_cam = Camera(c2w, w2c, proj_mtx, mvp_mtx, cam_pos)
        out = render(
            mesh,
            batch_cam,
            out_h,
            out_w,
            render_attr=True,
            render_depth=True,
            render_normal=True,
            depth_normalization_strategy=depth_norm,
            attr_background=0.0,
            raster_config=raster_config,
            device=dev,
        )
        rgb = out.attr
        geo_mask = out.mask
        tex_mask = (rgb.abs().sum(-1) > 1e-6) & geo_mask
        rgb = torch.where(tex_mask[..., None], rgb, 0.0)
        depth = torch.where(geo_mask, out.depth, 1.0)
        return rgb, depth, out.normal, tex_mask

    rgb, depth, normal, mask = chunk_batch(
        render_batch, render_chunk, cam.c2w, cam.w2c, cam.proj_mtx, cam.mvp_mtx,
        cam.cam_pos,
    )

    if ifproject:
        save_frames(rgb, output_dir / "rgb", "rgb")
        save_frames(mask, output_dir / "mask", "mask")
    save_depth_frames_16bit(depth, output_dir / "depth", "depth")
    save_frames(torch.clamp(normal * 0.5 + 0.5, 0, 1), output_dir / "normal", "normal")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Project video onto a scene and export rgb/depth/mask frames."
    )
    parser.add_argument("--uv-size", type=int, default=2048)
    parser.add_argument("--frame-step", type=int, default=1)
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--blender-bin", type=str, default="blender")
    parser.add_argument("--output-dir", type=str, default="output_project")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--axis-convert", action="store_true")
    parser.add_argument("--blend-path", type=str, required=True)
    parser.add_argument("--video-path", type=str, default=None)
    parser.add_argument("--next-camera-json", type=str, default=None)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--no-uv-unwarp", action="store_true")
    parser.add_argument(
        "--camera-json",
        type=str,
        default=None,
        help="pre-exported camera trajectory (required for non-.blend input)",
    )
    parser.add_argument(
        "--keyframes",
        action="store_true",
        help="project only from auto-selected trajectory keyframes",
    )
    parser.add_argument(
        "--raster", choices=["exact", "fast"], default="exact",
        help="fast = auto-tuned lossy-budget fused kernels (validated lossless for this scene)",
    )
    parser.add_argument("--keyframe-t-position", type=float, default=0.20)
    parser.add_argument("--keyframe-t-rotation", type=float, default=0.5)
    parser.add_argument(
        "--pos-error-eps", default="1e-3",
        help="world-unit reprojection-validity bound, or 'auto' to scale "
        "it to the view-pixel footprint (native-scale scenes)",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to run on (cuda, or cpu for the plain PyTorch path)",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    eps = args.pos_error_eps
    eps = eps if eps == "auto" else float(eps)
    project_and_render(
        mesh_path=args.blend_path,
        video_path=args.video_path,
        output_dir=args.output_dir,
        height=args.height,
        width=args.width,
        blender_bin=args.blender_bin,
        uv_size=args.uv_size,
        frame_step=max(1, args.frame_step),
        max_frames=args.max_frames,
        camera_json=args.camera_json,
        next_camera_json=args.next_camera_json,
        axis_convert=args.axis_convert,
        uv_unwarp=not args.no_uv_unwarp,
        keyframe_selection=args.keyframes,
        keyframe_t_position=args.keyframe_t_position,
        keyframe_t_rotation=args.keyframe_t_rotation,
        pos_error_eps=eps,
        debug=args.debug,
        raster=args.raster,
        device=args.device,
    )


if __name__ == "__main__":
    main()
