"""Video / frame IO of the PyTorch port: video -> float frame stacks, 8-bit
and 16-bit PNG frame writers (counterpart of
``worldrenderer_tpu/scene/video.py``).

Reading video needs OpenCV (``cv2``), imported inside the functions that
read. The writers need no image library: they encode PNGs with the port's
own codec (``scene/gltf.py``), with the JAX package's conversions, and
take one host copy of a tensor argument per call.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .gltf import _encode_png

__all__ = ["export_frames", "load_frames", "save_frames", "save_depth_frames_16bit"]


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading video needs OpenCV (the cv2 module), "
                          "which is not installed") from e
    return cv2


def _open_video(cv2, video_path):
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise RuntimeError(f"Failed to open video: {video_path}")
    return cap, int(cap.get(cv2.CAP_PROP_FRAME_COUNT))


def export_frames(video_path, output_dir, frame_offset: int = 0) -> None:
    """Dump video frames to ``frame_{i:05d}.png``, where output index i maps
    to source frame i + frame_offset; pairs falling outside the video are
    skipped. The valid output indices form one contiguous run: one seek to
    the first source frame, then sequential reads."""
    cv2 = _cv2()
    cap, total = _open_video(cv2, video_path)
    # i valid  <=>  0 <= i < total  and  0 <= i + frame_offset < total
    first = max(0, -frame_offset)
    last = min(total, total - frame_offset)  # exclusive
    os.makedirs(output_dir, exist_ok=True)
    if first + frame_offset > 0:
        cap.set(cv2.CAP_PROP_POS_FRAMES, first + frame_offset)
    for i in range(first, last):
        ok, frame = cap.read()
        if ok:
            cv2.imwrite(str(Path(output_dir) / f"frame_{i:05d}.png"), frame)
    cap.release()


def load_frames(
    video_path, frame_offset: int = -1, frame_step: int = 1, max_frames: int = -1
) -> np.ndarray:
    """Load video frames as (N, H, W, 3) float32 in [0, 1] (host numpy).

    Keeps frame k iff k is a multiple of ``frame_step`` AND k + frame_offset
    is a valid frame index, up to ``max_frames`` kept frames (the offset
    gates which frames are kept; the pixel data is always frame k itself).
    The wanted index set is computed up front and frames are read
    sequentially."""
    cv2 = _cv2()
    cap, total = _open_video(cv2, video_path)
    wanted = {
        k
        for k in range(0, total, max(1, frame_step))
        if 0 <= k + frame_offset < total
    }
    if max_frames > 0:
        wanted = set(sorted(wanted)[:max_frames])
    frames = []
    for k in range(max(wanted) + 1 if wanted else 0):
        ok, frame = cap.read()
        if not ok:
            break
        if k in wanted:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise RuntimeError("No frames loaded from video.")
    return np.stack(frames, axis=0).astype(np.float32) / 255.0


def _host(frames):
    """A tensor as one host numpy array; anything else as it is (a list of
    frames stays a list)."""
    if isinstance(frames, torch.Tensor):
        return frames.detach().cpu().numpy()
    return frames


def _to_uint8(frame: np.ndarray) -> np.ndarray:
    """The JAX package's conversion: float clipped to [0, 1] and scaled by
    255, truncated; bool to 0 / 255; uint8 as it is."""
    arr = np.asarray(frame)
    if arr.dtype in (np.float32, np.float64, np.float16):
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    elif arr.dtype == np.bool_:
        arr = arr.astype(np.uint8) * 255
    if arr.dtype != np.uint8:
        raise ValueError(f"save_frames: cannot write frames of dtype {arr.dtype}")
    return arr


def save_frames(frames, out_dir, prefix: str) -> None:
    """Save (N, H, W[, C]) frames as 8-bit PNGs ``{prefix}_{i:05d}.png``:
    gray, gray + alpha, RGB or RGBA by C."""
    frames = _host(frames)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(frames):
        (out_dir / f"{prefix}_{i:05d}.png").write_bytes(
            _encode_png(_to_uint8(_host(frame))))


def save_depth_frames_16bit(frames, out_dir, prefix: str) -> None:
    """Save (N, H, W) depth maps in [0, 1] as 16-bit gray PNGs:
    ``(clip(d, 0, 1) * 65535 + 0.5)`` truncated to uint16, in the frame's
    own float precision."""
    frames = _host(frames)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(frames):
        arr = np.clip(np.asarray(_host(frame)), 0.0, 1.0)
        arr16 = (arr * 65535.0 + 0.5).astype(np.uint16)
        (out_dir / f"{prefix}_{i:05d}.png").write_bytes(_encode_png(arr16))
