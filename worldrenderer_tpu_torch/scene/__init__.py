"""Scene interchange of the PyTorch port, host side (numpy): GLB / glTF
load and save with texture replacement, PLY load, the headless-Blender
bridge (GLB export, camera trajectories, 16-bit depth frames), camera
trajectories (JSON) and their keyframes, and video / frame IO. The entry
points that build tensors (``load_camera_from_json``, ``build_camera``)
take ``device``; PNG frames are written with the port's own codec, and
reading video needs OpenCV (``cv2``)."""

from .gltf import load_glb, parse_glb, replace_glb_texture, save_glb
from .camera_json import build_camera, load_camera_from_json, save_camera_json
from .blender import export_blend_to_glb, export_camera_json
from .blender_depth import export_depth_frames
from .keyframe import extract_keyframes, get_keyframes
from .ply import load_ply
from .video import (
    export_frames,
    load_frames,
    save_frames,
    save_depth_frames_16bit,
)

__all__ = [
    "load_glb",
    "save_glb",
    "replace_glb_texture",
    "build_camera",
    "load_camera_from_json",
    "save_camera_json",
    "export_blend_to_glb",
    "export_camera_json",
    "export_depth_frames",
    "extract_keyframes",
    "get_keyframes",
    "export_frames",
    "load_frames",
    "save_frames",
    "save_depth_frames_16bit",
    "parse_glb",
    "load_ply",
]
