"""Small export CLIs: camera trajectory from .blend, frames from video
(counterpart of ``worldrenderer_tpu/pipelines/export_tools.py``; host
only, no device)."""

from __future__ import annotations

import argparse

from ..scene.blender import export_camera_json
from ..scene.video import export_frames

__all__ = ["export_camera_main", "export_frames_main"]


def export_camera_main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export the camera trajectory of a .blend via headless Blender"
    )
    parser.add_argument("--blend-path", type=str, required=True)
    parser.add_argument("--camera-json", type=str, required=True)
    parser.add_argument("--blender-bin", type=str, default="blender")
    args = parser.parse_args(argv)
    export_camera_json(args.blend_path, args.camera_json, args.blender_bin)


def export_frames_main(argv=None):
    parser = argparse.ArgumentParser(description="Dump every video frame to PNG")
    parser.add_argument("--video-path", type=str, required=True)
    parser.add_argument("--output-dir", type=str, required=True)
    parser.add_argument("--frame-offset", type=int, default=0)
    args = parser.parse_args(argv)
    export_frames(args.video_path, args.output_dir, frame_offset=args.frame_offset)


if __name__ == "__main__":  # default to camera export when run directly
    export_camera_main()
