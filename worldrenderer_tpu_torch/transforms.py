"""Homogeneous / clip-space point transforms (PyTorch counterpart of
``worldrenderer_tpu/transforms.py``)."""

from __future__ import annotations

import math

import torch


def fma_f32(m: torch.Tensor, v: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """fp32 ``fma(m, v, acc)`` rounded once to nearest, from float64
    tensors that hold fp32 values (PyTorch has no fp32 FMA).

    The product of two fp32 values is exact in float64. The sum is rounded
    to odd in float64 — rounded to nearest, then, where TwoSum shows it
    inexact and its last bit is even, moved one ulp toward the exact value
    — and rounding to odd at 53 bits and then to nearest at 24 equals one
    rounding to nearest (53 >= 24 + 2), where a plain float64 sum would
    round twice and can miss at fp32 midpoints."""
    p = m * v
    s = p + acc
    bp = s - p
    err = (p - (s - bp)) + (acc - bp)  # p + acc == s + err exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def mvp_columns(
    mvp: torch.Tensor, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor
) -> torch.Tensor:
    """(B, 4, 4) matrices times the points (x, y, z, 1), each (K,) ->
    (B, 4, K), in true fp32: the chain of fused multiply-adds
    ``fma(m3, 1, fma(m2, z, fma(m1, y, m0 * x)))`` that XLA evaluates for
    the JAX package's ``Precision.HIGHEST`` 4-term dot on the CPU, each FMA
    rounded once (:func:`fma_f32`). So the CPU, the card and the reference
    get the same clip coordinates — the rasterizer's coverage tests depend
    on their last bits. Every clip coordinate in the port goes through
    here."""
    m = mvp.double()[..., None]  # (B, 4, 4, 1)
    acc = (m[:, :, 0] * x.double()).float()  # exact product, one rounding
    acc = fma_f32(m[:, :, 1], y.double(), acc.double())
    acc = fma_f32(m[:, :, 2], z.double(), acc.double())
    return acc + mvp[:, :, 3, None]  # fma(m3, 1, acc) is one rounded add


def get_clip_space_position(pos: torch.Tensor, mvp_mtx: torch.Tensor) -> torch.Tensor:
    """Transform (V, 3) world positions by (N, 4, 4) MVP matrices.
    Returns (N, V, 4) clip-space positions."""
    return mvp_columns(mvp_mtx, pos[:, 0], pos[:, 1], pos[:, 2]).transpose(1, 2)


def transform_points_homo(pos: torch.Tensor, mtx: torch.Tensor) -> torch.Tensor:
    """Transform batched points (N, ..., 3) by (N, 4, 4) matrices and
    return the first 3 components. Correct for affine matrices."""
    batch = pos.shape[0]
    inner = pos.shape[1:-1]
    flat = pos.reshape(batch, -1, 3)
    flat_homo = torch.cat([flat, torch.ones_like(flat[..., :1])], dim=-1)
    out = torch.einsum("nvj,nij->nvi", flat_homo, mtx)[..., :3]
    return out.reshape((batch,) + tuple(inner) + (3,))


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum-product over the last dim, keepdim."""
    return torch.sum(x * y, dim=-1, keepdim=True)
