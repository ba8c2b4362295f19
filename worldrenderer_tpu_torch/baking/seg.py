"""Background segmentation (foreground matting), an optional mask source of
``camera_projection(remove_bg=True, bg_remover=...)`` (PyTorch counterpart
of ``worldrenderer_tpu/baking/seg.py``).

``RMBGModel`` wraps the RMBG network through ``transformers``, loaded from
a local path the caller gives; ``ThresholdMatting`` is the weightless
matte of renders over a known background colour.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..transforms import norm

__all__ = ["SegmentationModel", "RMBGModel", "ThresholdMatting"]


def _images_on(images, device: DeviceLike) -> torch.Tensor:
    """Images as float32, on their own device if they are a tensor, else
    on ``device`` (the card unless ``device="cpu"``)."""
    if isinstance(images, torch.Tensor):
        return images.to(torch.float32)
    return torch.as_tensor(np.asarray(images), dtype=torch.float32,
                           device=resolve_device(device))


class SegmentationModel(ABC):
    """(Nv, H, W, C) float images in [0, 1] -> (Nv, H, W, 1) float matte."""

    @abstractmethod
    def __call__(self, images) -> torch.Tensor: ...


class ThresholdMatting(SegmentationModel):
    """Foreground = the pixels whose colour lies further than ``threshold``
    from ``bg_color``: a matte for renders over a known background."""

    def __init__(self, bg_color=(0.5, 0.5, 0.5), threshold: float = 0.05,
                 device: DeviceLike = None):
        self.bg_color = np.asarray(bg_color, np.float32)
        self.threshold = threshold
        self.device = device

    def __call__(self, images) -> torch.Tensor:
        images = _images_on(images, self.device)
        bg = torch.as_tensor(self.bg_color, device=images.device)
        dist = norm(images[..., :3] - bg)
        return (dist > self.threshold).to(torch.float32)[..., None]


class RMBGModel(SegmentationModel):
    """The RMBG matting network through ``transformers``
    (``AutoModelForImageSegmentation``), loaded from the local path
    ``pretrained_model_name_or_path`` (no download) onto ``device`` (the
    card unless ``device="cpu"``). Without ``transformers`` it raises
    ``ImportError``."""

    def __init__(self, pretrained_model_name_or_path: str,
                 device: DeviceLike = None):
        try:
            import transformers
        except ImportError as err:
            raise ImportError(
                "RMBGModel needs the 'transformers' package; install it, or "
                "pass another SegmentationModel as bg_remover") from err
        self.device = resolve_device(device)
        self.model = transformers.AutoModelForImageSegmentation.from_pretrained(
            pretrained_model_name_or_path, trust_remote_code=True,
            local_files_only=True,
        ).to(self.device)

    def __call__(self, images) -> torch.Tensor:
        x = _images_on(images, self.device)
        out_device = x.device
        batched = x.ndim == 4
        if not batched:
            x = x[None]
        with torch.no_grad():
            out = self.model(x.to(self.device).permute(0, 3, 1, 2) - 0.5)[0][0]
        out = out.clamp(0.0, 1.0).permute(0, 2, 3, 1).to(out_device)
        return out if batched else out[0]
