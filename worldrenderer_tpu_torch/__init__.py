"""worldrenderer_tpu_torch: the PyTorch / CUDA port of worldrenderer_tpu.

Same public API and the same ``RasterizerConfig`` as the JAX package, so
one config drives both. Entry points run on the card (``cuda``) unless the
caller passes ``device="cpu"``; the fused G-buffer tile pass is a
hand-written CUDA kernel for Hopper (``csrc/gbuffer_tiles.cu``) whose plain
PyTorch version runs on the CPU.
"""

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
from .mesh import (
    TexturedMesh,
    compute_vertex_normals,
    icosphere,
    make_grid_mesh,
    uv_sphere_mesh,
    with_normals,
)
from .ops.gbuffer import GBufferOutput, rasterize_gbuffer
from .ops.rasterize import (
    DEFAULT_CONFIG,
    FAST_TPU_CONFIG,
    RasterizerConfig,
    auto_fast_config,
    binning_stats,
)
from .render import (
    DepthControlNetNormalization,
    RenderOutput,
    SimpleNormalization,
    Zero123PlusPlusNormalization,
    render,
)
from .transforms import get_clip_space_position, transform_points_homo

__all__ = [
    "Camera", "affine_inverse", "get_c2w", "get_camera",
    "get_orthogonal_camera", "get_orthogonal_projection_matrix",
    "get_projection_matrix", "normalize", "rigid_inverse",
    "camera_from_arrays", "config_from_dict", "mesh_from_arrays",
    "TexturedMesh", "compute_vertex_normals", "icosphere", "make_grid_mesh",
    "uv_sphere_mesh", "with_normals",
    "GBufferOutput", "rasterize_gbuffer",
    "DEFAULT_CONFIG", "FAST_TPU_CONFIG", "RasterizerConfig",
    "auto_fast_config", "binning_stats",
    "DepthControlNetNormalization", "RenderOutput", "SimpleNormalization",
    "Zero123PlusPlusNormalization", "render",
    "get_clip_space_position", "transform_points_homo",
]
