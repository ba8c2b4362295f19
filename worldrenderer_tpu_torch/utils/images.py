"""Image <-> tensor conversion and grid assembly, host-side helpers built
on numpy and PIL (PyTorch counterpart of
``worldrenderer_tpu/utils/images.py``). PIL is imported by the functions
that need it."""

from __future__ import annotations

import math
from datetime import datetime
from typing import List, Optional

import numpy as np
import torch

__all__ = [
    "tensor_to_image",
    "image_to_tensor",
    "largest_factor_near_sqrt",
    "make_image_grid",
    "get_current_timestamp",
]

_RETURN_TYPES = ("pt", "np")


def tensor_to_image(data, batched: bool = False, format: str = "HWC"):
    """Tensor or array (a batch of them with ``batched``) -> PIL image(s).
    Float values in [0, 1] and bool masks are scaled to uint8; ``format``
    "CHW" moves the channel axis last first."""
    from PIL import Image

    if isinstance(data, Image.Image):
        return data
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    data = np.asarray(data)
    if data.dtype in (np.float32, np.float16, np.float64):
        data = (np.clip(data, 0.0, 1.0) * 255).astype(np.uint8)
    elif data.dtype == np.bool_:
        data = data.astype(np.uint8) * 255
    if data.dtype != np.uint8:
        raise TypeError(f"tensor_to_image: unsupported dtype {data.dtype}")
    if format == "CHW":
        if batched and data.ndim == 4:
            data = data.transpose(0, 2, 3, 1)
        elif not batched and data.ndim == 3:
            data = data.transpose(1, 2, 0)
    if batched:
        return [Image.fromarray(d) for d in data]
    return Image.fromarray(data)


def image_to_tensor(image, return_type: str = "pt"):
    """PIL image(s) or arrays -> float32 in [0, 1] (PIL images are divided
    by 255): a CPU tensor for ``return_type`` "pt", a numpy array for
    "np"."""
    from PIL import Image

    if return_type not in _RETURN_TYPES:
        raise ValueError(f"image_to_tensor: return_type must be one of "
                         f"{_RETURN_TYPES}, got {return_type!r}")
    batched = True
    if isinstance(image, Image.Image):
        batched = False
        image = [image]
    if isinstance(image, list):
        image = np.stack([np.asarray(img) for img in image], axis=0)
        image = image.astype(np.float32) / 255.0
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    image = np.asarray(image, np.float32)
    if not batched:
        image = image[0]
    if return_type == "pt":
        return torch.from_numpy(np.ascontiguousarray(image))
    return image


def largest_factor_near_sqrt(n: int) -> int:
    """The largest factor of ``n`` at most sqrt(n)."""
    sqrt_n = int(math.sqrt(n))
    if sqrt_n * sqrt_n == n:
        return sqrt_n
    for i in range(sqrt_n, 0, -1):
        if n % i == 0:
            return i
    return 1


def make_image_grid(images: List, rows: Optional[int] = None,
                    cols: Optional[int] = None, resize: Optional[int] = None):
    """Tile PIL images into one RGB grid image, ``rows`` x ``cols`` (the
    one missing from the other, or both from
    :func:`largest_factor_near_sqrt`)."""
    from PIL import Image

    if rows is None and cols is not None:
        if len(images) % cols:
            raise ValueError(f"{len(images)} images do not fill {cols} columns")
        rows = len(images) // cols
    elif cols is None and rows is not None:
        if len(images) % rows:
            raise ValueError(f"{len(images)} images do not fill {rows} rows")
        cols = len(images) // rows
    elif rows is None and cols is None:
        rows = largest_factor_near_sqrt(len(images))
        cols = len(images) // rows
    if len(images) != rows * cols:
        raise ValueError(f"{len(images)} images for a {rows}x{cols} grid")
    if resize is not None:
        images = [img.resize((resize, resize)) for img in images]
    w, h = images[0].size
    grid = Image.new("RGB", size=(cols * w, rows * h))
    for i, img in enumerate(images):
        grid.paste(img.convert("RGB"), box=(i % cols * w, i // cols * h))
    return grid


def get_current_timestamp(fmt: str = "%Y%m%d%H%M%S") -> str:
    return datetime.now().strftime(fmt)
