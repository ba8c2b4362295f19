"""Scene interchange of the PyTorch port, host side (numpy): GLB / glTF
load and save with texture replacement, PLY load, and Blender camera
trajectories (JSON). The entry points that build tensors
(``load_camera_from_json``, ``build_camera``) take ``device``."""

from .camera_json import build_camera, load_camera_from_json, save_camera_json
from .gltf import load_glb, parse_glb, replace_glb_texture, save_glb
from .ply import load_ply

__all__ = [
    "load_glb",
    "save_glb",
    "replace_glb_texture",
    "parse_glb",
    "load_ply",
    "build_camera",
    "load_camera_from_json",
    "save_camera_json",
]
