"""Camera-trajectory JSON interchange (Blender-exported per-frame cameras):
the PyTorch port of ``worldrenderer_tpu/scene/camera_json.py``, with the
same JSON schema ({frame, fov_deg, clip_start, clip_end, matrix_world}).

The JSON is parsed and converted to float32 on the host; the cameras are
then built by :func:`..camera.get_camera`, which builds on the host and
moves, so they carry the same bits on every device."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from .._device import DeviceLike
from ..camera import Camera, get_camera

__all__ = ["build_camera", "load_camera_from_json", "save_camera_json"]

# Blender -> glTF axis change of basis.
_BLENDER_TO_GLTF = np.array(
    [
        [1, 0, 0, 0],
        [0, 0, 1, 0],
        [0, -1, 0, 0],
        [0, 0, 0, 1],
    ],
    dtype=np.float32,
)


def build_camera(num_views: int, height: int, width: int,
                 device: DeviceLike = None) -> Camera:
    """Default orbit rig on ``device`` (the card unless ``device="cpu"``):
    evenly spaced azimuths at elevation 0, distance 2.5, fovy 60."""
    azimuth = np.linspace(0, 360, num_views + 1, dtype=np.float32)[:-1]
    return get_camera(
        elevation_deg=np.zeros_like(azimuth),
        distance=np.full_like(azimuth, 2.5),
        fovy_deg=np.full_like(azimuth, 60.0),
        azimuth_deg=azimuth,
        num_views=num_views,
        aspect_wh=width / height,
        device=device,
    )


def load_camera_from_json(
    json_path,
    height: int,
    width: int,
    max_views: int = 10**9,
    axis_convert: bool = False,
    device: DeviceLike = None,
) -> Tuple[Camera, float, float]:
    """Load per-frame cameras from a Blender camera-export JSON onto
    ``device`` (the card unless ``device="cpu"``).

    Returns (Camera batch, near, far) with near / far the median clip range
    across frames. As in the JAX package, the camera's own projection keeps
    ``get_camera``'s default near and far: the medians are returned for the
    caller, not applied. A ``matrix_world`` may carry scale (Blender's
    exports do); ``get_camera`` inverts it as an affine transform."""
    data = json.loads(Path(json_path).read_text())
    if len(data) == 0:
        raise RuntimeError("Camera json is empty.")
    data = data[:max_views]

    c2w = np.stack(
        [np.asarray(item["matrix_world"], np.float32) for item in data], axis=0
    )
    if axis_convert:
        axis = _BLENDER_TO_GLTF
        c2w = axis[None] @ c2w @ np.linalg.inv(axis)[None]
    fov = np.asarray([item["fov_deg"] for item in data], np.float32)
    clip_start = np.asarray(
        [item.get("clip_start", 0.1) for item in data], np.float32
    )
    clip_end = np.asarray([item.get("clip_end", 100.0) for item in data], np.float32)

    cam = get_camera(c2w=torch.from_numpy(np.ascontiguousarray(c2w)),
                     fovy_deg=fov, aspect_wh=width / height, device=device)

    near = float(np.median(clip_start))
    far = float(np.median(clip_end))
    if far <= near + 1e-6:
        near, far = 0.1, 100.0
    return cam, near, far


def save_camera_json(
    json_path,
    c2w: np.ndarray,
    fov_deg,
    clip_start: float = 0.1,
    clip_end: float = 100.0,
) -> None:
    """Write a camera trajectory in the JSON schema the Blender bridge
    produces, so synthetic rigs round-trip through the loader real scenes
    use. ``c2w`` (N, 4, 4) array or tensor."""
    if isinstance(c2w, torch.Tensor):
        c2w = c2w.detach().cpu().numpy()
    c2w = np.asarray(c2w, np.float64)
    fov_deg = np.broadcast_to(np.asarray(fov_deg, np.float64), (len(c2w),))
    data = [
        {
            "frame": int(i + 1),
            "fov_deg": float(fov_deg[i]),
            "clip_start": float(clip_start),
            "clip_end": float(clip_end),
            "matrix_world": c2w[i].tolist(),
        }
        for i in range(len(c2w))
    ]
    path = Path(json_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data))
