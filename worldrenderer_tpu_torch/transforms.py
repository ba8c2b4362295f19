"""Homogeneous / clip-space point transforms (PyTorch counterpart of
``worldrenderer_tpu/transforms.py``)."""

from __future__ import annotations

import math

import numpy as np
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
    ``fma(m3, 1, fma(m2, z, fma(m1, y, m0 * x)))``, each FMA rounded once
    (:func:`fma_f32`). So the CPU and the card get the same clip
    coordinates — the rasterizer's coverage tests depend on their last
    bits. Every clip coordinate in the port goes through here.

    It is the order XLA's CPU GEMM takes for the JAX package's
    ``Precision.HIGHEST`` 4-term dot at some vertex counts only: op by op
    it matches at 128, 256, 512, 561, 1,024, 2,048 and 4,096 vertices; at
    97, 100, 129, 200, 300, 1,000 and 2,081 XLA sums pairwise, ``(x m0 + y
    m1) + (z m2 + m3)``, and at 153, 160, 2,079 and 2,080 it takes neither
    form. The port keeps one order for every shape."""
    m = mvp.double()[..., None]  # (B, 4, 4, 1)
    acc = (m[:, :, 0] * x.double()).float()  # exact product, one rounding
    acc = fma_f32(m[:, :, 1], y.double(), acc.double())
    acc = fma_f32(m[:, :, 2], z.double(), acc.double())
    return acc + mvp[:, :, 3, None]  # fma(m3, 1, acc) is one rounded add


def inverse_f32(m: torch.Tensor) -> torch.Tensor:
    """The fp32 inverse of each (..., n, n) matrix, on the host, in the
    rounding order of the JAX package's ``jnp.linalg.inv`` on the CPU:
    LAPACK's ``sgetrf``, the row swaps applied to the identity, then
    ``strsm`` with the unit lower factor and with the upper one. Those are
    the LAPACK and BLAS routines jaxlib's CPU backend calls, taken here from
    SciPy's copies. ``torch.linalg.inv`` rounds apart from them (2,071 of
    3,264 elements of 204 random 4x4 matrices). Returns a CPU tensor."""
    from scipy.linalg import blas, lapack

    a = m.detach().cpu().float().numpy()
    n = a.shape[-1]
    flat = a.reshape(-1, n, n)
    out = np.empty_like(flat)
    eye = np.eye(n, dtype=np.float32)
    for i, mat in enumerate(flat):
        lu, piv, _ = lapack.sgetrf(mat)
        perm = np.arange(n)
        for k, p in enumerate(piv):
            perm[k], perm[p] = perm[p], perm[k]
        y = blas.strsm(1.0, lu, eye[perm], lower=1, diag=1)
        out[i] = blas.strsm(1.0, lu, y, lower=0, diag=0)
    return torch.from_numpy(out.reshape(a.shape))


def get_clip_space_position(pos: torch.Tensor, mvp_mtx: torch.Tensor) -> torch.Tensor:
    """Transform (V, 3) world positions by (N, 4, 4) MVP matrices.
    Returns (N, V, 4) clip-space positions."""
    return mvp_columns(mvp_mtx, pos[:, 0], pos[:, 1], pos[:, 2]).transpose(1, 2)


def transform_points_homo(pos: torch.Tensor, mtx: torch.Tensor) -> torch.Tensor:
    """Transform batched points (N, ..., 3) by (N, 4, 4) matrices and
    return the first 3 components. Correct for affine matrices. Rounded as
    the JAX package's HIGHEST einsum on the CPU at a G-buffer's sizes: each
    product rounded, then (x m0 + y m1) + (z m2 + m3); each op is a kernel
    of its own, so the card rounds as the CPU does."""
    batch = pos.shape[0]
    inner = pos.shape[1:-1]
    flat = pos.reshape(batch, -1, 3)
    cols = mtx[:, None, :3]  # (N, 1, 3 i, 4 j)
    out = ((flat[..., 0:1] * cols[..., 0] + flat[..., 1:2] * cols[..., 1])
           + (flat[..., 2:3] * cols[..., 2] + cols[..., 3]))
    return out.reshape((batch,) + tuple(inner) + (3,))


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum-product over the last dim, keepdim."""
    return torch.sum(x * y, dim=-1, keepdim=True)


def cross(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The cross product of 3-vectors along ``dim`` (broadcast), rounded as
    the JAX package's ``jnp.cross`` op by op: each component two rounded
    products and one rounded difference, ``a1*b2 - a2*b1``, ``a2*b0 -
    a0*b2``, ``a0*b1 - a1*b0``. Each operation is a torch op of its own, so
    no device contracts it into an FMA (PyTorch's own cross product rounds
    apart from it)."""
    a0, a1, a2 = a.unbind(dim)
    b0, b1, b2 = b.unbind(dim)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0],
                       dim=dim)


def norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """The 2-norm along ``dim``, rounded as the JAX package's
    ``jnp.linalg.norm`` op by op at the short axes the port takes norms of
    (2, 3 and 4 long): each element squared and rounded, the squares summed
    in index order, ``(x0² + x1²) + x2²``, the root taken in float64 and
    rounded once (the CPU's fp32 ``torch.sqrt`` is not correctly rounded,
    and ``linalg.vector_norm`` sums with FMAs). Each operation is a torch op
    of its own, so the card rounds as the CPU does."""
    sq = x * x
    total = sq.select(dim, 0)
    for i in range(1, x.shape[dim]):
        total = total + sq.select(dim, i)
    root = torch.sqrt(total.double()).to(x.dtype)
    return root.unsqueeze(dim) if keepdim else root
