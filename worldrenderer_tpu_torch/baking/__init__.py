"""Inverse rendering: UV-space rasterization, view -> UV projection and
multi-view blending (PyTorch counterpart of
``worldrenderer_tpu/baking/``; ``warp``, ``smart_paint`` and ``seg`` are
not ported yet)."""

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
]
