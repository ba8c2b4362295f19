"""Inverse rendering: UV-space rasterization, view -> UV projection and
multi-view blending, the warp fit of views to renders, the iterative
smart painter and the background-matting hooks (PyTorch counterpart of
``worldrenderer_tpu/baking/``)."""

from .projection import CameraProjection, CameraProjectionOutput, camera_projection
from .uv import (
    ExponentialBlend,
    RandomChoiceBlend,
    SimpleUVValidityStrategy,
    UVBlendOutput,
    UVPrecomputeOutput,
    UVRenderAttrOutput,
    UVRenderGeometryOutput,
    uv_blend,
    uv_padding,
    uv_precompute,
    uv_render_attr,
    uv_render_geometry,
)
from .smart_paint import SmartPainter, default_inpaint_func
from .warp import compute_warp_field, construct_grid_mesh
from .seg import RMBGModel, SegmentationModel, ThresholdMatting

__all__ = [
    "UVPrecomputeOutput",
    "UVRenderGeometryOutput",
    "UVRenderAttrOutput",
    "UVBlendOutput",
    "SimpleUVValidityStrategy",
    "ExponentialBlend",
    "RandomChoiceBlend",
    "uv_precompute",
    "uv_render_geometry",
    "uv_render_attr",
    "uv_blend",
    "uv_padding",
    "CameraProjection",
    "CameraProjectionOutput",
    "camera_projection",
    "SmartPainter",
    "default_inpaint_func",
    "compute_warp_field",
    "construct_grid_mesh",
    "SegmentationModel",
    "RMBGModel",
    "ThresholdMatting",
]
