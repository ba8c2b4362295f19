"""Image-space ops: Sobel gradients, morphology, iterative inpaint
(PyTorch counterpart of ``worldrenderer_tpu/ops/image.py``).

Every 3x3 stencil is written out as shifted sums in a fixed order, not
``F.conv2d``: on the card a convolution goes to cuDNN, which may round in
TF32 and picks its own summation order, while explicit sums give the card
the CPU's bits. The orders are those in which the JAX package's fp32
convolutions (``Precision.HIGHEST``, XLA on the CPU) round, and square
roots are correctly rounded (``tensor.sqrt_f32``). Max pooling is exact in
any order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from .tensor import sqrt_f32

__all__ = [
    "sobel_grad_magnitude",
    "max_pool2d",
    "batch_dilate",
    "batch_erode",
    "inpaint",
    "batch_inpaint",
]


def _shifts(x: torch.Tensor):
    """``s(dy, dx)``: x shifted so pixel (y, x) reads x[y + dy, x + dx],
    zero outside; x (..., H, W), |dy|, |dx| <= 1."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    return lambda dy, dx: p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def sobel_grad_magnitude(img: torch.Tensor, device: DeviceLike = None) -> torch.Tensor:
    """Sobel gradient magnitude of (B, H, W) maps with zero padding:
    3x3 Sobel x / y (cross-correlation), then sqrt(gx^2 + gy^2). The taps
    sum in the kernel's row-major order."""
    img = torch.as_tensor(img, dtype=torch.float32, device=resolve_device(device))
    s = _shifts(img)
    gx = (s(-1, -1) - s(-1, 1) + s(0, -1) * 2.0 + s(0, 1) * -2.0
          + s(1, -1) - s(1, 1))
    gy = (s(-1, -1) + s(-1, 0) * 2.0 + s(-1, 1) - s(1, -1)
          + s(1, 0) * -2.0 - s(1, 1))
    return sqrt_f32(gx * gx + gy * gy)


def max_pool2d(x: torch.Tensor, kernel_size: int, padding: int = None,
               device: DeviceLike = None) -> torch.Tensor:
    """Stride-1 max pool of (B, H, W) maps, -inf padded by ``padding``
    (default ``kernel_size // 2``; an even kernel then shifts by half a
    pixel and grows the map by one, as in the JAX package)."""
    x = torch.as_tensor(x, device=resolve_device(device))
    if kernel_size <= 1:
        return x
    if padding is None:
        padding = kernel_size // 2
    p = F.pad(x, (padding,) * 4, value=-float("inf"))
    return F.max_pool2d(p[:, None], kernel_size, stride=1)[:, 0]


def batch_dilate(masks: torch.Tensor, kernel_size: int,
                 device: DeviceLike = None) -> torch.Tensor:
    """Binary dilation of (B, H, W) masks, in the masks' dtype."""
    masks = torch.as_tensor(masks, device=resolve_device(device))
    out = max_pool2d(masks.float(), kernel_size, padding=kernel_size // 2,
                     device=masks.device)
    return (out > 0).to(masks.dtype)


def batch_erode(masks: torch.Tensor, kernel_size: int,
                device: DeviceLike = None) -> torch.Tensor:
    """Binary erosion of (B, H, W) masks, in the masks' dtype (outside the
    map counts as set, as the JAX package's -inf padded min pool does)."""
    masks = torch.as_tensor(masks, device=resolve_device(device))
    out = -max_pool2d(-masks.float(), kernel_size, padding=kernel_size // 2,
                      device=masks.device)
    return (out > 0.5).to(masks.dtype)


def _neighbour_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the four axis neighbours of (C, H, W) maps, zero outside,
    rounded as (up + right) + (left + down)."""
    s = _shifts(x)
    return (s(-1, 0) + s(0, 1)) + (s(0, -1) + s(1, 0))


def _inpaint_chw(attr: torch.Tensor, known: torch.Tensor, radius: int):
    """``radius`` masked neighbour-average steps over (C, H, W) ``attr``
    with (H, W) {0, 1} ``known``: each unknown pixel with a known neighbour
    takes their mean and becomes known."""
    for _ in range(radius):
        nb_sum = _neighbour_sum(attr * known)
        nb_cnt = _neighbour_sum(known[None])[0]
        filled = nb_sum / torch.clamp(nb_cnt, min=1.0)
        newly = (known == 0.0) & (nb_cnt > 0.0)
        attr = torch.where(newly, filled, attr)
        known = torch.where(newly, 1.0, known)
    return attr


def inpaint(image: torch.Tensor, mask: torch.Tensor, radius: int,
            device: DeviceLike = None) -> torch.Tensor:
    """Fill the ``mask`` pixels of (H, W, C) ``image`` by diffusing known
    neighbours outward ``radius`` steps; pixels further than ``radius`` from
    known content stay as they are."""
    dev = resolve_device(device)
    image = torch.as_tensor(image, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    known = ((1.0 - mask.float()) > 0.5).float()
    out = _inpaint_chw(image.permute(2, 0, 1), known, radius)
    return out.permute(1, 2, 0)


def batch_inpaint(images: torch.Tensor, masks: torch.Tensor, radius: int,
                  device: DeviceLike = None) -> torch.Tensor:
    """:func:`inpaint` over a leading view axis: (B, H, W, C) images,
    (B, H, W) masks."""
    dev = resolve_device(device)
    return torch.stack([inpaint(i, m, radius, device=dev)
                        for i, m in zip(images, masks)])
