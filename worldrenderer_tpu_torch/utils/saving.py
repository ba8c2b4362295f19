"""SaverMixin: artifact output sinks (images, grids, colormaps, videos,
arrays, checkpoints); PyTorch counterpart of
``worldrenderer_tpu/utils/saving.py``.

RGB / UV / grayscale image savers (with matplotlib colormaps), image grids
with a text overlay, npz / npy dumps, state-dict saves, and regex-matched
image sequences to mp4 / gif. PIL, matplotlib and imageio encode on the
host, each imported inside the function that needs it; a tensor on any
device is copied to the host once per call.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence

import numpy as np

from .misc import _to_numpy, save_checkpoint

__all__ = ["SaverMixin"]


def _to_uint8(img: np.ndarray, data_range=(0, 1)) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    lo, hi = data_range
    img = (np.clip(img, lo, hi) - lo) / (hi - lo)
    return (img * 255.0 + 0.5).astype(np.uint8)


def _apply_colormap(gray: np.ndarray, cmap: Optional[str]) -> np.ndarray:
    if cmap is None:
        return np.repeat(gray[..., None], 3, axis=-1)
    if cmap == "jet":
        import matplotlib.cm as cm

        return (cm.jet(gray.astype(np.float32) / 255.0)[..., :3] * 255).astype(
            np.uint8
        )
    if cmap == "magma":
        import matplotlib.cm as cm

        return (cm.magma(gray.astype(np.float32) / 255.0)[..., :3] * 255).astype(
            np.uint8
        )
    raise ValueError(f"unknown cmap {cmap!r}")


class SaverMixin:
    """Mix into pipelines/systems to get artifact saving under a save dir.

    Optional wandb mirroring (reference saving.py:115-118, saving.py:207-210):
    call ``enable_wandb()``; every image save is then also logged if wandb is
    importable and initialized — silently skipped otherwise."""

    _save_dir: Optional[str] = None
    _wandb_logging: bool = False

    def set_save_dir(self, save_dir: str) -> None:
        self._save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

    def enable_wandb(self, enabled: bool = True) -> None:
        self._wandb_logging = enabled

    def _maybe_log_wandb(self, key: str, path: str) -> None:
        if not self._wandb_logging:
            return
        try:
            import wandb

            if wandb.run is not None:
                wandb.log({key: wandb.Image(path)})
        except Exception:
            pass

    def get_save_dir(self) -> str:
        if self._save_dir is None:
            raise ValueError("Save dir is not set")
        return self._save_dir

    def get_save_path(self, filename: str) -> str:
        save_path = os.path.join(self.get_save_dir(), filename)
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        return save_path

    # -- images -------------------------------------------------------------

    def save_rgb_image(
        self, filename: str, img, data_range=(0, 1)
    ) -> str:
        from PIL import Image

        path = self.get_save_path(filename)
        Image.fromarray(_to_uint8(_to_numpy(img), data_range)).save(path)
        self._maybe_log_wandb(filename, path)
        return path

    def save_grayscale_image(
        self,
        filename: str,
        img,
        data_range=(0, 1),
        cmap: Optional[str] = None,
    ) -> str:
        from PIL import Image

        path = self.get_save_path(filename)
        gray = _to_uint8(_to_numpy(img), data_range)
        Image.fromarray(_apply_colormap(gray, cmap)).save(path)
        return path

    def save_uv_image(
        self, filename: str, img, data_range=(0, 1)
    ) -> str:
        """Texture-space image (same encoding as RGB; kept for API parity
        with reference save_uv_image)."""
        return self.save_rgb_image(filename, img, data_range)

    def save_mask_image(self, filename: str, mask) -> str:
        from PIL import Image

        path = self.get_save_path(filename)
        arr = (_to_numpy(mask).astype(np.uint8)) * 255
        Image.fromarray(arr).save(path)
        return path

    def save_image_grid(
        self,
        filename: str,
        imgs: Sequence,
        rows: Optional[int] = None,
        cols: Optional[int] = None,
        texts: Optional[Sequence[str]] = None,
        data_range=(0, 1),
    ) -> str:
        """Tile images into a grid with optional per-cell text overlay
        (reference saving.py image grids)."""
        from PIL import Image, ImageDraw

        arrs = [_to_uint8(_to_numpy(im), data_range) for im in imgs]
        n = len(arrs)
        if rows is None and cols is None:
            cols = int(np.ceil(np.sqrt(n)))
        if rows is None:
            rows = int(np.ceil(n / cols))
        if cols is None:
            cols = int(np.ceil(n / rows))
        h, w = arrs[0].shape[:2]
        grid = Image.new("RGB", (cols * w, rows * h))
        for i, arr in enumerate(arrs):
            if arr.ndim == 2:
                arr = np.repeat(arr[..., None], 3, axis=-1)
            cell = Image.fromarray(arr[..., :3])
            if texts is not None and i < len(texts):
                ImageDraw.Draw(cell).text((4, 4), str(texts[i]), fill=(255, 0, 0))
            grid.paste(cell, (i % cols * w, i // cols * h))
        path = self.get_save_path(filename)
        grid.save(path)
        return path

    def save_cubemap(
        self, filename: str, faces, data_range=(0, 1)
    ) -> str:
        """Save 6 cubemap faces (+x, -x, +y, -y, +z, -z) in the standard
        horizontal-cross layout (reference saving.py:412-445)."""
        faces = [_to_uint8(_to_numpy(f), data_range) for f in faces]
        assert len(faces) == 6
        h, w = faces[0].shape[:2]
        c = faces[0].shape[2] if faces[0].ndim == 3 else 1
        canvas = np.zeros((3 * h, 4 * w, c), np.uint8)
        # layout:      [ +y ]
        #         [-x][+z][+x][-z]
        #              [ -y ]
        px, nx, py, ny, pz, nz = faces
        canvas[0:h, w : 2 * w] = py.reshape(h, w, c)
        canvas[h : 2 * h, 0:w] = nx.reshape(h, w, c)
        canvas[h : 2 * h, w : 2 * w] = pz.reshape(h, w, c)
        canvas[h : 2 * h, 2 * w : 3 * w] = px.reshape(h, w, c)
        canvas[h : 2 * h, 3 * w : 4 * w] = nz.reshape(h, w, c)
        canvas[2 * h : 3 * h, w : 2 * w] = ny.reshape(h, w, c)
        from PIL import Image

        path = self.get_save_path(filename)
        Image.fromarray(canvas.squeeze()).save(path)
        return path

    # -- arrays / state -----------------------------------------------------

    def save_npz(self, filename: str, **arrays) -> str:
        path = self.get_save_path(filename)
        np.savez(path, **{k: _to_numpy(v) for k, v in arrays.items()})
        return path

    def save_npy(self, filename: str, array) -> str:
        path = self.get_save_path(filename)
        np.save(path, _to_numpy(array))
        return path

    def save_state_dict(
        self, filename: str, state: dict, epoch: int = 0, global_step: int = 0
    ) -> str:
        path = self.get_save_path(filename)
        save_checkpoint(path, state, epoch=epoch, global_step=global_step)
        return path

    # -- videos -------------------------------------------------------------

    def save_img_sequence(
        self,
        filename: str,
        img_dir: str,
        matcher: str,
        save_format: str = "mp4",
        fps: int = 30,
    ) -> str:
        """Assemble regex-matched images under ``img_dir`` (relative to the
        save dir) into an mp4/gif (reference saving.py:466-499)."""
        assert save_format in ("mp4", "gif")
        if not filename.endswith(save_format):
            filename += f".{save_format}"
        path = self.get_save_path(filename)
        matcher_re = re.compile(matcher)
        img_dir_abs = os.path.join(self.get_save_dir(), img_dir)
        matched = []
        for f in os.listdir(img_dir_abs):
            if matcher_re.search(f):
                matched.append(f)
        if not matched:
            raise ValueError(f"no images matched {matcher!r} in {img_dir_abs}")
        matched = sorted(matched)

        import imageio.v2 as imageio

        frames = [imageio.imread(os.path.join(img_dir_abs, f)) for f in matched]
        if save_format == "mp4":
            imageio.mimsave(path, frames, fps=fps)
        else:
            imageio.mimsave(path, frames, duration=1000 / fps)
        return path
