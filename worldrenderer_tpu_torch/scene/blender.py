"""Headless-Blender subprocess bridge: .blend -> GLB, per-frame camera export
(a copy of ``worldrenderer_tpu/scene/blender.py`` for the PyTorch port).

Host-side subprocess calls; the generated bpy script emits the JSON schema
that :mod:`.camera_json` reads, character for character the JAX package's.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

__all__ = ["export_blend_to_glb", "export_camera_json"]

_CAMERA_EXPORT_SCRIPT = """\
import bpy, json, math
scene = bpy.context.scene
cam = scene.camera
if cam is None:
    raise RuntimeError('No active camera in scene')
data = []
for f in range(scene.frame_start, scene.frame_end + 1):
    scene.frame_set(f)
    mw = cam.matrix_world
    fov = cam.data.angle * 180.0 / math.pi
    data.append({
        'frame': int(f),
        'fov_deg': float(fov),
        'clip_start': float(cam.data.clip_start),
        'clip_end': float(cam.data.clip_end),
        'matrix_world': [[float(mw[i][j]) for j in range(4)] for i in range(4)]
    })
with open(r"__JSON_PATH__", 'w') as fp:
    json.dump(data, fp)
"""


def export_blend_to_glb(blend_path, glb_path, blender_bin="blender") -> None:
    """Export a .blend scene to GLB with headless Blender. Skips if the GLB
    already exists (reference glb.py:6-8)."""
    glb_path = Path(glb_path)
    if glb_path.exists():
        return
    glb_path.parent.mkdir(parents=True, exist_ok=True)
    expr = (
        "import bpy; "
        "bpy.ops.export_scene.gltf(filepath=r'%s', export_format='GLB')"
    ) % glb_path
    subprocess.run(
        [str(blender_bin), "-b", str(blend_path), "--python-expr", expr],
        check=True,
    )


def export_camera_json(blend_path, json_path, blender_bin="blender") -> None:
    """Export per-frame camera world matrices + fov + clip range to JSON via
    a generated bpy script (reference camera.py:26-59)."""
    json_path = Path(json_path)
    json_path.parent.mkdir(parents=True, exist_ok=True)
    script_path = json_path.parent / "_export_camera_tmp.py"
    script_path.write_text(
        _CAMERA_EXPORT_SCRIPT.replace("__JSON_PATH__", str(json_path))
    )
    subprocess.run(
        [str(blender_bin), "-b", str(blend_path), "--python", str(script_path)],
        check=True,
    )
