"""worldrenderer_tpu_torch: the PyTorch / CUDA port of worldrenderer_tpu.

Same public API and the same ``RasterizerConfig`` as the JAX package, so
one config drives both. Entry points run on the card (``cuda``) unless the
caller passes ``device="cpu"``; host IO (``load_mesh``, ``scene``) and
the LOD chain's decimation (``meshproc``) run on the host and move their
results there. The rasterizer's tile passes are
hand-written CUDA kernels for Hopper (``csrc/``) whose plain PyTorch
versions run on the CPU; so are the measurement probes of ``probes/``.
``baking`` projects multi-view images onto a mesh's UV texture, fits
views to renders (``compute_warp_field``) and inpaints what no view saw
(``SmartPainter``); ``rasterize_diff`` gives vertex-position gradients.
``parallel`` splits views and bake texel rows over a mesh of devices and
runs the texture fit data-parallel over ``torch.distributed``.
"""

from . import baking, geometry, ops, parallel, scene, utils

from .camera import (
    Camera,
    affine_inverse,
    get_c2w,
    get_camera,
    get_orthogonal_camera,
    get_orthogonal_projection_matrix,
    get_projection_matrix,
    normalize,
    rigid_inverse,
)
from .convert import camera_from_arrays, config_from_dict, mesh_from_arrays
from .lod import LODChain, build_lod_chain, select_lod_level
from .mesh import (
    TexturedMesh,
    compute_vertex_normals,
    compute_vertex_tangents,
    icosphere,
    is_registered_quantized_texture,
    is_watertight,
    load_mesh,
    make_grid_mesh,
    merge_duplicate_vertices,
    mesh_use_texture,
    register_quantized_texture,
    unify_mesh_uv,
    uv_sphere_mesh,
    with_normals,
)
from .ops.antialias import antialias
from .ops.gbuffer import GBufferOutput, rasterize_gbuffer
from .ops.grid_sample import grid_sample
from .ops.interpolate import interpolate
from .ops.rasterize import (
    DEFAULT_CONFIG,
    FAST_TPU_CONFIG,
    RasterizerConfig,
    auto_fast_config,
    binning_stats,
    rasterize,
    rasterize_db,
    rasterize_diff,
)
from .ops.texture import texture, texture_construct_mip
from .render import (
    DepthControlNetNormalization,
    RenderOutput,
    SimpleNormalization,
    Zero123PlusPlusNormalization,
    render,
)
from .transforms import dot, get_clip_space_position, transform_points_homo

__all__ = [
    "Camera", "affine_inverse", "get_c2w", "get_camera",
    "get_orthogonal_camera", "get_orthogonal_projection_matrix",
    "get_projection_matrix", "normalize", "rigid_inverse",
    "camera_from_arrays", "config_from_dict", "mesh_from_arrays",
    "TexturedMesh", "compute_vertex_normals", "compute_vertex_tangents",
    "icosphere", "is_registered_quantized_texture", "make_grid_mesh",
    "mesh_use_texture", "register_quantized_texture", "unify_mesh_uv",
    "uv_sphere_mesh", "with_normals",
    "load_mesh", "merge_duplicate_vertices", "is_watertight",
    "LODChain", "build_lod_chain", "select_lod_level",
    "antialias", "GBufferOutput", "rasterize_gbuffer", "interpolate",
    "rasterize", "rasterize_db", "rasterize_diff", "texture",
    "texture_construct_mip", "grid_sample", "baking", "geometry", "ops",
    "parallel", "scene", "utils",
    "DEFAULT_CONFIG", "FAST_TPU_CONFIG", "RasterizerConfig",
    "auto_fast_config", "binning_stats",
    "DepthControlNetNormalization", "RenderOutput", "SimpleNormalization",
    "Zero123PlusPlusNormalization", "render",
    "dot", "get_clip_space_position", "transform_points_homo",
]
