"""Rasterizer ops of the PyTorch port: setup, binning and the classic API
(``rasterize``, ``interpolate``), the fused G-buffer paths (``gbuffer``)
and their CUDA kernels (``gbuffer_cuda``, ``zattr_cuda``,
``raster_zid_cuda``, built by ``_build``), texture sampling (``texture``),
silhouette antialiasing (``antialias``), grid sampling
(``grid_sample``), image ops (``image``), Poisson blending
(``poisson``) and the tensor helpers (``tensor``)."""

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
from .gbuffer import GBufferOutput, rasterize_gbuffer
from .rasterize import (
    RasterizerConfig,
    auto_fast_config,
    rasterize,
    rasterize_db,
    rasterize_diff,
)
from .tensor import (
    binary_cross_entropy,
    c2w_to_polar,
    chunk_batch,
    fourier_position_encoding,
    get_activation,
    get_intrinsic_from_fov,
    get_mvp_matrix,
    get_plucker_rays,
    polar_to_c2w,
    rays_intersect_bbox,
    reflect,
    scale_tensor,
    tet_sdf_diff,
    trunc_exp,
    validate_empty_rays,
)
from .texture import texture, texture_construct_mip

__all__ = [
    "antialias", "interpolate", "texture", "texture_construct_mip",
    "grid_sample", "sobel_grad_magnitude", "max_pool2d", "batch_dilate",
    "batch_erode", "inpaint", "batch_inpaint", "poisson_blend",
    "poisson_blend_cropped", "poisson_blend_multigrid",
    "PoissonBlendingSolver", "RasterizerConfig", "auto_fast_config",
    "rasterize", "rasterize_db", "rasterize_gbuffer", "GBufferOutput",
    "rasterize_diff", "reflect", "scale_tensor",
    "trunc_exp", "get_activation", "chunk_batch", "get_mvp_matrix",
    "rays_intersect_bbox", "get_plucker_rays", "c2w_to_polar",
    "polar_to_c2w", "fourier_position_encoding", "get_intrinsic_from_fov",
    "binary_cross_entropy", "tet_sdf_diff", "validate_empty_rays",
]
