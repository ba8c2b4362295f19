"""Blender-side 16-bit ground-truth depth export (a copy of
``worldrenderer_tpu/scene/blender_depth.py`` for the PyTorch port).

A bpy script sets up a compositor mapping Z to [0, 1] with a stable depth
range from the scene objects' bounding boxes relative to the camera (5%
padding), falling back to the camera clip range, then renders every frame
as a 16-bit grayscale PNG: reference depth for the renderer's depth output.
The script is emitted text, run through headless Blender as a subprocess
(bpy only exists inside Blender); it equals the JAX package's character
for character.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

__all__ = ["export_depth_frames", "DEPTH_EXPORT_SCRIPT"]

DEPTH_EXPORT_SCRIPT = r'''
import os
import bpy
from mathutils import Vector

scene = bpy.context.scene

# -- compositor: fixed-range depth mapping (no per-frame normalization, so
#    frames don't flicker) --------------------------------------------------
scene.view_layers["ViewLayer"].use_pass_z = True
scene.use_nodes = True
tree = scene.node_tree
tree.nodes.clear()
rl = tree.nodes.new("CompositorNodeRLayers")
mv = tree.nodes.new("CompositorNodeMapValue")

clip_start, clip_end = 0.1, 100.0
cam = scene.camera
if cam is not None and cam.data.clip_end > cam.data.clip_start:
    clip_start = float(cam.data.clip_start)
    clip_end = float(cam.data.clip_end)

# Stable range from object bounding boxes vs camera (with 5% padding).
try:
    cam_loc = cam.matrix_world.to_translation() if cam else Vector((0, 0, 0))
    min_d, max_d = float("inf"), 0.0
    for obj in scene.objects:
        if obj.type != "MESH":
            continue
        for corner in obj.bound_box:
            d = (obj.matrix_world @ Vector(corner) - cam_loc).length
            if d > 0.0:
                min_d = min(min_d, d)
                max_d = max(max_d, d)
    if min_d != float("inf") and max_d > 0.0:
        span = max(max_d - min_d, 1e-4)
        pad = span * 0.05
        clip_start = max(1e-4, min_d - pad)
        clip_end = max(clip_start + 1e-4, max_d + pad)
except Exception:
    pass

span = max(clip_end - clip_start, 1e-6)
size = 1.0 / span
offset = -clip_start * size
n = len(mv.offset) if hasattr(mv.offset, "__len__") else 1
mv.offset = [offset] * n
mv.size = [size] * n
mv.min = [0.0] * n
mv.max = [1.0] * n
mv.use_min = True
mv.use_max = True

comp = tree.nodes.new("CompositorNodeComposite")
tree.links.new(rl.outputs["Depth"], mv.inputs[0])
tree.links.new(mv.outputs[0], comp.inputs["Image"])

# -- render settings: 16-bit grayscale PNG, cheap sampling ------------------
scene.render.image_settings.file_format = "PNG"
scene.render.image_settings.color_mode = "BW"
scene.render.image_settings.color_depth = "16"
scene.render.use_file_extension = True
scene.render.engine = "CYCLES"
scene.cycles.samples = 1

out_dir = r"__OUT_DIR__"
os.makedirs(out_dir, exist_ok=True)
for frame in range(scene.frame_start, scene.frame_end + 1):
    scene.frame_set(frame)
    scene.render.filepath = os.path.join(out_dir, f"{frame:04d}.png")
    try:
        bpy.ops.render.render(write_still=True)
    except Exception as e:
        print(f"render failed at frame {frame}: {e}")
'''


def export_depth_frames(blend_path, out_dir, blender_bin: str = "blender") -> None:
    """Render per-frame 16-bit depth PNGs from a .blend with headless
    Blender (reference depth.py export())."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    script_path = out_dir / "_export_depth_tmp.py"
    script_path.write_text(
        DEPTH_EXPORT_SCRIPT.replace("__OUT_DIR__", str(out_dir))
    )
    subprocess.run(
        [str(blender_bin), "-b", str(blend_path), "--python", str(script_path)],
        check=True,
    )
