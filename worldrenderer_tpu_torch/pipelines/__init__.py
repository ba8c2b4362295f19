"""The application layer of the PyTorch port: the texture-baking pipeline
and the CLI apps (counterpart of ``worldrenderer_tpu/pipelines/``)."""

from .texture_pipeline import (
    ModProcessConfig,
    TexturePipeline,
    TexturePipelineOutput,
)
from .project_render import project_and_render

__all__ = [
    "ModProcessConfig",
    "TexturePipeline",
    "TexturePipelineOutput",
    "project_and_render",
]
