"""Multi-device paths of the PyTorch port (counterpart of
``worldrenderer_tpu/parallel/``): device meshes of ``torch.device``s,
view-split render sweeps, the texel-sharded UV bake, the sweep runner, and
process coordination over ``torch.distributed``."""

from .bake import sharded_camera_projection
from .device_mesh import make_device_mesh, replicated_sharding, view_sharding
from .dist import (
    barrier,
    broadcast_from_main,
    initialize_distributed,
    is_main_process,
    process_index,
)
from .sweep import make_texture_fit_step, render_views_sharded, texture_fit_step

__all__ = [
    "make_device_mesh",
    "sharded_camera_projection",
    "view_sharding",
    "replicated_sharding",
    "render_views_sharded",
    "texture_fit_step",
    "make_texture_fit_step",
    "initialize_distributed",
    "process_index",
    "is_main_process",
    "barrier",
    "broadcast_from_main",
]
