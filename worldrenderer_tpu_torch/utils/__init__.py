"""Host helpers of the PyTorch port (counterpart of the parts of
``worldrenderer_tpu/utils/`` ported so far): image <-> tensor conversion
and image grids (``images``)."""

from .images import (
    get_current_timestamp,
    image_to_tensor,
    largest_factor_near_sqrt,
    make_image_grid,
    tensor_to_image,
)

__all__ = [
    "tensor_to_image",
    "image_to_tensor",
    "largest_factor_near_sqrt",
    "make_image_grid",
    "get_current_timestamp",
]
