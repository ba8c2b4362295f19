"""Bilinear / nearest / bicubic sampling at normalized device coordinates
(PyTorch counterpart of ``worldrenderer_tpu/ops/grid_sample.py``).

``torch.nn.functional.grid_sample(align_corners=False,
padding_mode='zeros')`` semantics, channels-last: images (N, H, W, C),
grids (N, Hg, Wg, 2) in (x, y) order, outputs (N, Hg, Wg, C). The
coordinates, floors, fractions, zero-padded quad rows and the blend follow
the JAX package's expressions, so the port's CPU and card runs give the
JAX package's values; ``F.grid_sample`` rounds its weights otherwise, and a
texel near a validity threshold would flip.

Bilinear sampling reads one row of a quad table per output pixel (see
``ops/texture.py``); :func:`grid_sample_parts` puts several images' quad
tables side by side, fp32 columns and byte-packed ``'u8'`` words, so they
ride one row gather.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .._device import DeviceLike, resolve_device, to_int32_sat
from .texture import _pack_u8_words, _quantize_u8, _unpack_u8_words

__all__ = ["grid_sample", "grid_sample_parts"]


def _pixel_coords(grid: torch.Tensor, h: int, w: int):
    """align_corners=False: x = (gx + 1) * (w / 2) - 1/2, likewise y."""
    x = (grid[..., 0] + 1.0) * (w * 0.5) - 0.5
    y = (grid[..., 1] + 1.0) * (h * 0.5) - 0.5
    return x, y


def _gather(image: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """image[n, iy, ix] per output pixel (indices clamped), 0 where
    ``valid`` is False: (N, Hg, Wg, C)."""
    n, h, w, c = image.shape
    flat = torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)
    off = torch.arange(n, device=image.device).reshape(n, *([1] * (flat.ndim - 1)))
    out = image.reshape(n * h * w, c)[flat.long() + off * (h * w)]
    return torch.where(valid[..., None], out, 0.0)


def grid_sample(
    image: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    pack_mode: str = "none",
    device: DeviceLike = None,
) -> torch.Tensor:
    """Sample ``image`` (N, H, W, C) at ``grid`` (N, Hg, Wg, 2) NDC
    coordinates on ``device`` (the card unless ``device="cpu"``).
    align_corners=False; out-of-bounds taps read 0.

    ``mode``: "bilinear", "nearest" (round half to even) or "bicubic"
    (a = -0.75). ``pack_mode="u8"`` (bilinear only) gathers the taps as
    byte-packed words: exact iff every pixel value is k/255."""
    dev = resolve_device(device)
    image = torch.as_tensor(image, dtype=torch.float32, device=dev)
    grid = torch.as_tensor(grid, dtype=torch.float32, device=dev)
    _, h, w, _ = image.shape
    x, y = _pixel_coords(grid, h, w)
    if mode == "nearest":
        ix = to_int32_sat(torch.round(x))
        iy = to_int32_sat(torch.round(y))
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        return _gather(image, iy, ix, valid)
    if mode == "bicubic":
        return _bicubic(image, x, y)
    if mode != "bilinear":
        raise NotImplementedError(f"grid_sample mode {mode!r}")
    return grid_sample_parts([(image, pack_mode)], grid, device=dev)


def _quad_of(src: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H+1, W+1, 4C): zero-padded by one pixel, row
    (y + 1, x + 1) holds the taps [t(y,x), t(y,x+1), t(y+1,x), t(y+1,x+1)]."""
    n, h, w, c = src.shape
    p = src.new_zeros((n, h + 2, w + 2, c))
    p[:, 1:-1, 1:-1] = src
    return torch.cat(
        [p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1], p[:, 1:, 1:]], dim=-1
    )


def grid_sample_parts(
    parts: Sequence[Tuple[torch.Tensor, str]],
    grid: torch.Tensor,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Bilinear :func:`grid_sample` of several same-size images with ONE
    row gather: every part's quad row in one table row (fp32 columns for
    ``'none'`` parts, byte-packed int32 words for ``'u8'`` parts), split
    after the gather. Each channel equals a separate call's bit for bit.
    Returns the parts' samples concatenated in the parts' order.

    parts: ((N, H, W, C_i) image, pack_mode) with shared (N, H, W);
    grid: (N, Hg, Wg, 2) NDC."""
    if not parts:
        raise ValueError("grid_sample_parts needs at least one part")
    dev = resolve_device(device)
    images = [torch.as_tensor(im, dtype=torch.float32, device=dev)
              for im, _ in parts]
    modes = [pm for _, pm in parts]
    n, h, w = images[0].shape[:3]
    for im in images[1:]:
        if tuple(im.shape[:3]) != (n, h, w):
            raise ValueError("all parts must share (N, H, W): "
                             f"{[tuple(i.shape) for i in images]}")
    for pm in modes:
        if pm not in ("none", "u8"):
            raise ValueError(f"unknown pack_mode {pm!r}")
    grid = torch.as_tensor(grid, dtype=torch.float32, device=dev)
    x, y = _pixel_coords(grid, h, w)
    x0 = to_int32_sat(torch.floor(x))
    y0 = to_int32_sat(torch.floor(y))
    fx = (x - x0.float())[..., None]
    fy = (y - y0.float())[..., None]
    qh, qw = h + 1, w + 1
    flat = torch.clamp(y0 + 1, 0, h) * qw + torch.clamp(x0 + 1, 0, w)

    # One table per pack mode, each from its parts merged first; with both
    # modes the fp32 table rides as its int32 bits beside the u8 words.
    f32_ims = [im for im, pm in zip(images, modes) if pm == "none"]
    u8_ims = [im for im, pm in zip(images, modes) if pm == "u8"]
    groups = []  # (kind, channels, table (N, qh*qw, cols))
    if f32_ims:
        im = torch.cat(f32_ims, dim=-1)
        q = _quad_of(im).reshape(n, qh * qw, -1)
        groups.append(("f32", im.shape[-1], q.view(torch.int32) if u8_ims else q))
    if u8_ims:
        im = torch.cat(u8_ims, dim=-1)
        groups.append(("u8", im.shape[-1], _pack_u8_words(_quad_of(_quantize_u8(im)))))
    table = torch.cat([g[2] for g in groups], dim=-1)
    cols = table.shape[-1]
    off = torch.arange(n, device=dev).reshape(n, *([1] * (flat.ndim - 1)))
    taps_all = table.reshape(n * qh * qw, cols)[flat.long() + off * (qh * qw)]

    in_x0 = ((x0 >= 0) & (x0 < w))[..., None]
    in_x1 = ((x0 + 1 >= 0) & (x0 + 1 < w))[..., None]
    in_y0 = ((y0 >= 0) & (y0 < h))[..., None]
    in_y1 = ((y0 + 1 >= 0) & (y0 + 1 < h))[..., None]
    w00 = (1.0 - fx) * (1.0 - fy) * (in_x0 & in_y0)
    w01 = fx * (1.0 - fy) * (in_x1 & in_y0)
    w10 = (1.0 - fx) * fy * (in_x0 & in_y1)
    w11 = fx * fy * (in_x1 & in_y1)

    group_out = {}
    at = 0
    for kind, c_ch, tab in groups:
        taps = taps_all[..., at:at + tab.shape[-1]]
        at += tab.shape[-1]
        if kind == "u8":
            taps = _unpack_u8_words(taps, 4 * c_ch)
        elif taps.dtype != torch.float32:
            taps = taps.view(torch.float32)
        group_out[kind] = (
            taps[..., 0 * c_ch:1 * c_ch] * w00
            + taps[..., 1 * c_ch:2 * c_ch] * w01
            + taps[..., 2 * c_ch:3 * c_ch] * w10
            + taps[..., 3 * c_ch:4 * c_ch] * w11
        )
    offs = {"f32": 0, "u8": 0}
    outs = []
    for im, pm in zip(images, modes):
        kind = "f32" if pm == "none" else "u8"
        o, c_ch = offs[kind], im.shape[-1]
        outs.append(group_out[kind][..., o:o + c_ch])
        offs[kind] = o + c_ch
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def _cubic_weights(t: torch.Tensor, a: float = -0.75):
    """Cubic convolution weights of the taps at offsets -1, 0, 1, 2 from
    floor(x) (a = -0.75, as torch's bicubic grid_sample)."""
    t2 = t * t
    t3 = t2 * t
    w_m1 = a * (t3 - 2 * t2 + t)
    w_0 = (a + 2) * t3 - (a + 3) * t2 + 1
    w_1 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w_2 = a * (t2 - t3)
    return (w_m1, w_0, w_1, w_2)


def _bicubic(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    _, h, w, _ = image.shape
    x0 = to_int32_sat(torch.floor(x))
    y0 = to_int32_sat(torch.floor(y))
    wx = _cubic_weights(x - x0.float())
    wy = _cubic_weights(y - y0.float())
    out = 0.0
    for j, wyj in enumerate(wy):
        for i, wxi in enumerate(wx):
            ix = x0 + (i - 1)
            iy = y0 + (j - 1)
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            out = out + _gather(image, iy, ix, valid) * (wxi * wyj)[..., None]
    return out
