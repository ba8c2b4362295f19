"""Poisson (seamless-clone) blending by Jacobi sweeps on the 2D grid
(PyTorch counterpart of ``worldrenderer_tpu/ops/poisson.py``).

The sweep runs on the (H, W, C) grid as a 4-neighbour stencil, as in the
JAX package:

    B       = lap(src or mixed guidance) + neighbour_sum(tgt * ~mask)
    X_{t+1} = mask * (neighbour_sum(X_t) + B) / 4
    out     = where(mask, clip(X_final, 0, 1), tgt)

Every op is a plain PyTorch op in the JAX package's expression order
(``up + down + left + right``; ``maskf * (nsum + b) * 0.25``), so the CPU
and the card give the same bits; the sweeps are a plain Python loop of
such ops (the JAX package has no kernel here).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device

__all__ = [
    "poisson_blend",
    "poisson_blend_multigrid",
    "poisson_blend_cropped",
    "PoissonBlendingSolver",
]


def _shift_pads(x: torch.Tensor):
    """The four axis neighbours of (H, W, ...) ``x``, zero padded: up reads
    row y + 1, down y - 1, left column x + 1, right x - 1."""
    trail = (0, 0) * (x.ndim - 2)
    up = F.pad(x[1:], trail + (0, 0, 0, 1))
    down = F.pad(x[:-1], trail + (0, 0, 1, 0))
    left = F.pad(x[:, 1:], trail + (0, 1))
    right = F.pad(x[:, :-1], trail + (1, 0))
    return up, down, left, right


def _neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 axis neighbours with zero boundary, as
    ``up + down + left + right``. x: (H, W, C) or (H, W)."""
    up, down, left, right = _shift_pads(x)
    return up + down + left + right


def _laplacian(x: torch.Tensor) -> torch.Tensor:
    """4 * x - neighbour_sum(x), zero-padded boundary."""
    return 4.0 * x - _neighbor_sum(x)


def _directional_laps(x: torch.Tensor) -> torch.Tensor:
    """The 4 one-sided differences (x - neighbour), stacked on axis 0
    (up, down, left, right): (H, W, C) -> (4, H, W, C)."""
    return torch.stack([x - n for n in _shift_pads(x)])


def _guidance(src, tgt, grad_mode):
    if grad_mode == "src":
        return _laplacian(src)
    sl = _directional_laps(src)
    tl = _directional_laps(tgt)
    if grad_mode == "max":
        return _sum4(torch.where(sl.abs() > tl.abs(), sl, tl))
    if grad_mode == "avg":
        return 0.5 * _sum4(sl + tl)
    raise ValueError(f"unknown grad_mode {grad_mode!r}")


def _sum4(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis of four, in order."""
    return ((x[0] + x[1]) + x[2]) + x[3]


def _inner(mask: torch.Tensor) -> torch.Tensor:
    """``mask`` with its one-pixel border cleared."""
    border = torch.zeros_like(mask)
    border[1:-1, 1:-1] = True
    return mask & border


def _as_mask(mask: torch.Tensor) -> torch.Tensor:
    if mask.ndim == 3:
        return mask.float().mean(-1) > 0.5
    return mask.float() > 0.5


def _jacobi(x, maskf, b, num_iters: int):
    for _ in range(num_iters):
        x = maskf * (_neighbor_sum(x) + b) * 0.25
    return x


def poisson_blend(
    src: torch.Tensor,
    mask: torch.Tensor,
    tgt: torch.Tensor,
    num_iters: int = 1000,
    grad_mode: str = "src",
    device: DeviceLike = None,
) -> torch.Tensor:
    """Seamlessly clone ``src`` into ``tgt`` over ``mask`` on ``device``
    (the card unless ``device="cpu"``).

    src, tgt: (H, W, C) float; mask: (H, W) bool or float (> 0.5 inside),
    or (H, W, C) (its channel mean). grad_mode: 'src' | 'max' | 'avg'
    guidance gradients."""
    dev = resolve_device(device)
    src = torch.as_tensor(src, dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
    mask = _inner(_as_mask(torch.as_tensor(mask, device=dev)))
    maskf = mask.float()[..., None]
    lap = _guidance(src, tgt, grad_mode)
    # Dirichlet boundary flux: the neighbour sum of tgt outside the mask.
    b = lap + _neighbor_sum(tgt * (1.0 - maskf))
    x = _jacobi(tgt * maskf, maskf, b, num_iters)
    return torch.where(mask[..., None], torch.clamp(x, 0.0, 1.0), tgt)


def _down2(x: torch.Tensor) -> torch.Tensor:
    """2x average pool (channels-last or 2D)."""
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


def poisson_blend_multigrid(
    src: torch.Tensor,
    mask: torch.Tensor,
    tgt: torch.Tensor,
    num_iters: int = 60,
    grad_mode: str = "src",
    levels: int = 4,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Coarse-to-fine cascade: Jacobi at 1/2^l resolutions, each upsampled
    solution initializing the next finer level; ``num_iters`` sweeps per
    level. Approximate (not equal to :func:`poisson_blend`)."""
    dev = resolve_device(device)
    src = torch.as_tensor(src, dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
    mask = _as_mask(torch.as_tensor(mask, device=dev))
    srcs, tgts, masks = [src], [tgt], [mask]
    for _ in range(levels - 1):
        if min(srcs[-1].shape[0], srcs[-1].shape[1]) < 16:
            break
        srcs.append(_down2(srcs[-1]))
        tgts.append(_down2(tgts[-1]))
        masks.append(_down2(masks[-1].float()) > 0.5)

    x = None
    for s, t, m in zip(reversed(srcs), reversed(tgts), reversed(masks)):
        h, w = m.shape
        maskf = _inner(m).float()[..., None]
        b = _guidance(s, t, grad_mode) + _neighbor_sum(t * (1.0 - maskf))
        if x is None:
            x = t * maskf
        else:  # the coarser solution, upsampled, as the initial guess
            x = x.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w] * maskf
        x = _jacobi(x, maskf, b, num_iters)
    final_mask = _inner(masks[0])
    return torch.where(final_mask[..., None], torch.clamp(x, 0.0, 1.0), tgt)


def poisson_blend_cropped(
    src, mask, tgt, num_iters: int = 1000, grad_mode: str = "src",
    margin: int = 8, bucket: int = 256, method: str = "jacobi",
    device: DeviceLike = None,
) -> torch.Tensor:
    """Solve only the mask's bounding box (plus ``margin``, rounded up to
    ``bucket`` multiples and clamped to the image), as the JAX package's
    host wrapper does; the box comes from one host copy of the mask."""
    dev = resolve_device(device)
    mask = torch.as_tensor(mask, device=dev)
    tgt = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
    mask_np = mask.detach().cpu().numpy()
    if mask_np.ndim == 3:
        mask_np = mask_np.astype(np.float32).mean(-1) > 0.5
    ys, xs = np.nonzero(mask_np)
    if len(ys) == 0:
        return tgt
    h, w = mask_np.shape
    y0 = max(0, int(ys.min()) - margin)
    y1 = min(h, int(ys.max()) + 1 + margin)
    x0 = max(0, int(xs.min()) - margin)
    x1 = min(w, int(xs.max()) + 1 + margin)
    ch = min(h, -(-(y1 - y0) // bucket) * bucket)
    cw = min(w, -(-(x1 - x0) // bucket) * bucket)
    y0 = min(y0, h - ch)
    x0 = min(x0, w - cw)
    sl = (slice(y0, y0 + ch), slice(x0, x0 + cw))
    solver = poisson_blend if method == "jacobi" else poisson_blend_multigrid
    src = torch.as_tensor(src, dtype=torch.float32, device=dev)
    crop_mask = torch.from_numpy(np.ascontiguousarray(mask_np[sl])).to(dev)
    solved = solver(src[sl], crop_mask, tgt[sl], num_iters=num_iters,
                    grad_mode=grad_mode, device=dev)
    out = tgt.clone()
    out[sl] = solved
    return out


class PoissonBlendingSolver:
    """The reference's solver object over :func:`poisson_blend`; its
    ``backend`` names one of several implementations there and is accepted
    and ignored here. ``device`` is where the solve runs (the card unless
    "cpu")."""

    def __init__(self, backend: str = "torch", device: DeviceLike = None):
        del backend
        self.device = device

    def __call__(self, src, mask, tgt, num_iters: int, inplace: bool = True,
                 grad_mode: str = "src"):
        del inplace  # always returns a new tensor
        return poisson_blend(src, mask, tgt, num_iters=num_iters,
                             grad_mode=grad_mode, device=self.device)
