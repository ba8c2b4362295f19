"""Camera-trajectory keyframe extraction (a copy of
``worldrenderer_tpu/scene/keyframe.py`` for the PyTorch port; host-side
float64 numpy).

Greedy keyframe selection by position delta and SVD-orthonormalized
rotation geodesic distance against the last accepted keyframe.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Sequence

import numpy as np

__all__ = ["extract_keyframes", "get_keyframes", "save_keyframes"]


def _orthonormalize(rot: np.ndarray) -> np.ndarray:
    u, _, vt = np.linalg.svd(rot)
    return u @ vt


def _rotation_distance(r1: np.ndarray, r2: np.ndarray) -> float:
    """Geodesic angle between two (approximate) rotation matrices
    (reference keyframe.py:10-23)."""
    r1 = _orthonormalize(np.asarray(r1, np.float64)[:3, :3])
    r2 = _orthonormalize(np.asarray(r2, np.float64)[:3, :3])
    trace = np.trace(r1.T @ r2)
    return float(np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0)))


def _is_keyframe(prev_mw, curr_mw, t_position: float, t_rotation: float) -> bool:
    """Position/rotation-delta keyframe test (reference keyframe.py:30-41).
    Matches the reference's slicing: positions are taken from the matrix's
    third row translation column layout ([:3][-1] == row 2)."""
    prev_mw = np.asarray(prev_mw, np.float64)
    curr_mw = np.asarray(curr_mw, np.float64)
    p1, p2 = prev_mw[:3, 3], curr_mw[:3, 3]
    dist_p = float(np.linalg.norm(p1 - p2))
    dist_r = _rotation_distance(prev_mw, curr_mw)
    if dist_p < 0.1:
        return dist_r > t_rotation
    return dist_p > t_position or dist_r > t_rotation


def extract_keyframes(
    camera_data: Sequence[dict], t_position: float = 0.5, t_rotation: float = 0.1
) -> List[int]:
    """Greedy keyframe indices; frame 0 is always a keyframe
    (reference keyframe.py:43-52)."""
    keyframes = [0]
    for i in range(1, len(camera_data)):
        if _is_keyframe(
            camera_data[keyframes[-1]]["matrix_world"],
            camera_data[i]["matrix_world"],
            t_position,
            t_rotation,
        ):
            keyframes.append(i)
    return keyframes


def get_keyframes(
    json_path, num_views: int, t_position: float = 0.5, t_rotation: float = 0.1
) -> List[int]:
    """Load a camera JSON and extract keyframes from the first ``num_views``
    frames (reference keyframe.py:61-66)."""
    camera_data = json.loads(Path(json_path).read_text())[:num_views]
    return extract_keyframes(camera_data, t_position, t_rotation)


def save_keyframes(output_file, keyframe_indices: Sequence[int]) -> None:
    Path(output_file).write_text(json.dumps(list(map(int, keyframe_indices))))
