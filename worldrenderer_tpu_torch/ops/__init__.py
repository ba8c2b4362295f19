"""Rasterizer ops of the PyTorch port: setup, binning and the classic API
(``rasterize``, ``interpolate``), the fused G-buffer paths (``gbuffer``)
and their CUDA kernels (``gbuffer_cuda``, ``zattr_cuda``,
``raster_zid_cuda``, built by ``_build``), texture sampling (``texture``),
silhouette antialiasing (``antialias``), grid sampling
(``grid_sample``), image ops (``image``) and Poisson blending
(``poisson``)."""

from .antialias import antialias
from .grid_sample import grid_sample
from .image import (
    batch_dilate,
    batch_erode,
    batch_inpaint,
    inpaint,
    max_pool2d,
    sobel_grad_magnitude,
)
from .interpolate import interpolate
from .poisson import (
    PoissonBlendingSolver,
    poisson_blend,
    poisson_blend_cropped,
    poisson_blend_multigrid,
)
from .texture import texture, texture_construct_mip

__all__ = [
    "antialias", "interpolate", "texture", "texture_construct_mip",
    "grid_sample", "sobel_grad_magnitude", "max_pool2d", "batch_dilate",
    "batch_erode", "inpaint", "batch_inpaint", "poisson_blend",
    "poisson_blend_cropped", "poisson_blend_multigrid",
    "PoissonBlendingSolver",
]
