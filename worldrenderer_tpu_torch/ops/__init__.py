"""Rasterizer ops of the PyTorch port: setup, binning and the classic API
(``rasterize``, ``interpolate``), the fused G-buffer paths (``gbuffer``)
and their CUDA kernels (``gbuffer_cuda``, ``zattr_cuda``,
``raster_zid_cuda``, built by ``_build``), texture sampling (``texture``)
and silhouette antialiasing (``antialias``)."""

from .antialias import antialias
from .interpolate import interpolate
from .texture import texture, texture_construct_mip

__all__ = ["antialias", "interpolate", "texture", "texture_construct_mip"]
