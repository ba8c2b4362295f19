"""View-to-view reprojection app: project frame i onto the mesh, then render
from camera i+1 and compare against frame i+1 (counterpart of
``worldrenderer_tpu/pipelines/pipeline_view.py``). A geometric sanity check
of the whole projection stack against real footage, on ``device`` (the
card unless ``device="cpu"``; the CLI's ``--device`` defaults to
``cuda``). Reading the footage needs OpenCV.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..baking.projection import camera_projection
from ..mesh import load_mesh
from ..render import render
from ..scene.blender import export_blend_to_glb, export_camera_json
from ..scene.camera_json import load_camera_from_json
from ..scene.video import load_frames, save_frames

__all__ = ["project_view_to_view", "main"]


def project_view_to_view(
    mesh_path,
    video_path,
    output_dir,
    blender_bin: str = "blender",
    uv_size: int = 2048,
    frame_index: int = 0,
    axis_convert: bool = False,
    device: DeviceLike = None,
) -> Optional[float]:
    """Project frame ``i`` into UV, render from camera ``i+1``, save the
    pair and return the masked L1 error against frame ``i+1``."""
    dev = resolve_device(device)
    mesh_path = Path(mesh_path)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    if mesh_path.suffix == ".blend":
        glb_path = mesh_path.with_suffix(".glb")
        camera_json = output_dir / "camera.json"
        export_blend_to_glb(mesh_path, glb_path, blender_bin)
        export_camera_json(mesh_path, camera_json, blender_bin)
    else:
        glb_path = mesh_path
        camera_json = output_dir / "camera.json"

    frames = load_frames(video_path, 0, 1, frame_index + 2)
    if frames.shape[0] < frame_index + 2:
        raise ValueError(
            f"need at least {frame_index + 2} frames, got {frames.shape[0]}"
        )
    h, w = frames.shape[1:3]
    cam, _, _ = load_camera_from_json(
        camera_json, h, w, max_views=frame_index + 2, axis_convert=axis_convert,
        device=dev,
    )

    mesh = load_mesh(str(glb_path), default_uv_size=uv_size, device=dev)

    out = camera_projection(
        images=torch.as_tensor(frames[frame_index : frame_index + 1], device=dev),
        mesh=mesh,
        cam=cam[frame_index],
        uv_size=uv_size,
        poisson_blending=False,
        iou_rejection_threshold=None,
        device=dev,
    )
    mesh = mesh._replace(texture=out.uv_proj)

    rendered = render(
        mesh, cam[frame_index + 1], h, w,
        render_attr=True, render_depth=False, render_normal=False,
        attr_background=0.0, device=dev,
    )
    pred = rendered.attr[0].cpu().numpy()
    mask = rendered.mask[0].cpu().numpy()
    target = frames[frame_index + 1]

    save_frames([frames[frame_index]], output_dir, "source")
    save_frames([pred], output_dir, "reprojected")
    save_frames([target], output_dir, "target")

    err = float(np.abs(pred - target)[mask].mean()) if mask.any() else None
    if err is not None:
        print(f"view-to-view masked L1 error: {err:.4f}")
    return err


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--blend-path", type=str, required=True)
    parser.add_argument("--video-path", type=str, required=True)
    parser.add_argument("--output-dir", type=str, default="output_view")
    parser.add_argument("--blender-bin", type=str, default="blender")
    parser.add_argument("--uv-size", type=int, default=2048)
    parser.add_argument("--frame-index", type=int, default=0)
    parser.add_argument("--axis-convert", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    project_view_to_view(
        args.blend_path, args.video_path, args.output_dir,
        blender_bin=args.blender_bin, uv_size=args.uv_size,
        frame_index=args.frame_index, axis_convert=args.axis_convert,
        device=args.device,
    )


if __name__ == "__main__":
    main()
