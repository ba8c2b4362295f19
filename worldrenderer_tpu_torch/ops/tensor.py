"""Small tensor helpers shared by the tile kernels' wrappers and plain
versions (PyTorch counterparts of the parts of
``worldrenderer_tpu/ops/tensor.py`` the port needs)."""

from __future__ import annotations

import torch

from ..transforms import fma_f32

# e0 constant of an invalid or padded entry: swallows any tile-origin
# rebase exactly in f32, so the entry never covers a pixel.
BIG_NEG = -3.0e38

# Tiles the plain versions evaluate together: their float64 FMA emulation
# keeps a step's temporaries at a few hundred MB.
PLAIN_TILES_PER_STEP = 8


def route(name: str, device: torch.device, plain, launch):
    """A tile kernel's wrapper: ``plain()`` for CPU tensors, ``launch()``
    (the CUDA kernel) for CUDA tensors; any other device raises."""
    if device.type == "cpu":
        return plain()
    if device.type != "cuda":
        raise ValueError(f"no {name} route for device {device}")
    return launch()


def chunk_size(chunk: int) -> int:
    """The chunk the tile kernels run with: a multiple of 128, at least
    128."""
    return max(128, (chunk // 128) * 128)


def edge0_pad_block(r: int, pad: int, neg: float, device=None) -> torch.Tensor:
    """A ``(3, r, pad)`` plane-coefficient padding block, zero except the
    edge-0 constant row ``[2, 0, :]``, which is ``neg``: padded rasterizer
    slots are never covered."""
    block = torch.zeros((3, r, pad), dtype=torch.float32, device=device)
    block[2, 0] = neg
    return block


def pad_tile_blocks(coeffs: torch.Tensor, r: int, counts: torch.Tensor,
                    chunk: int):
    """A dense (n_tiles, 3, r*K) coefficient block as (n_tiles, 3, r, Kp),
    K padded to a multiple of the chunk c by never-covering slots, as the
    TPU wrappers pad; the chunks each tile scans, ceil(count / c); c."""
    n_tiles = coeffs.shape[0]
    k = coeffs.shape[2] // r
    c = chunk_size(chunk)
    co = coeffs.reshape(n_tiles, 3, r, k)
    pad = (-k) % c
    if pad:
        block = edge0_pad_block(r, pad, BIG_NEG, coeffs.device)
        co = torch.cat([co, block.expand(n_tiles, 3, r, pad)], dim=3)
    nch = (counts.long().clamp(0, k) + (c - 1)) // c
    return co, nch, c


def pixel_centres(tile_h: int, tile_w: int, device=None):
    """(lx, ly) f32 pixel centres of a tile, row-major."""
    pix = torch.arange(tile_h * tile_w, device=device)
    return ((pix % tile_w).to(torch.float32) + 0.5,
            (pix // tile_w).to(torch.float32) + 0.5)


def plane_dot(a, b, g, lx, ly) -> torch.Tensor:
    """``a*lx + b*ly + g`` rounded as the JAX package's fp32 plane dot
    ``(a, b, g) . (lx, ly, 1)`` at ``Precision.HIGHEST`` rounds on the CPU:
    ``fma(b, ly, a*lx) + g``. The tile kernels K2 and K4 evaluate in this
    order."""
    return fma_f32(b.double(), ly.double(), (a * lx).double()) + g


def plane_vpu(a, b, g, lx, ly) -> torch.Tensor:
    """``lx*a + ly*b + g`` rounded as XLA contracts the jitted elementwise
    form on the CPU: ``fma(lx, a, ly*b) + g``. Kernel K3 evaluates in this
    order."""
    return fma_f32(lx.double(), a.double(), (ly * b).double()) + g


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 square root, on the CPU as on the card (and
    as XLA's): PyTorch's vectorized fp32 ``sqrt`` on the CPU misses the
    correctly rounded result for some inputs; the float64 root rounded to
    fp32 is exact (53 >= 2 * 24 + 2)."""
    return torch.sqrt(x.double()).float()


def fma_dot3(x: torch.Tensor, y: torch.Tensor, dim: int) -> torch.Tensor:
    """``sum_i x_i * y_i`` over the three entries of ``dim``, rounded as
    the reference's 3-term fp32 ``einsum`` at ``Precision.HIGHEST`` rounds
    on the CPU: ``fma(x2, y2, fma(x1, y1, x0 * y0))``."""
    x0, x1, x2 = x.unbind(dim)
    y0, y1, y2 = y.unbind(dim)
    acc = fma_f32(x1.double(), y1.double(), (x0 * y0).double()).double()
    return fma_f32(x2.double(), y2.double(), acc)
