"""Experiment scaffolding of the PyTorch port (counterpart of
``worldrenderer_tpu/utils/``): config, base classes, logging, saving,
profiling, image helpers; ``roofline`` and ``validate`` are imported by
name (``worldrenderer_tpu_torch.utils.roofline``)."""

from .config import (
    ExperimentConfig,
    dump_config,
    load_config,
    parse_structured,
    register_resolver,
)
from .base import BaseObject, Configurable, Updateable, update_if_possible
from .misc import (
    C,
    TimeRecorder,
    device_memory_stats,
    find,
    get_rank,
    load_checkpoint,
    save_checkpoint,
    time_recorder,
)
from .logging import get_logger, set_verbosity
from .saving import SaverMixin
from .debug import annotate, check_finite, debug_nans, trace
from .callbacks import (
    CodeSnapshotCallback,
    ConfigSnapshotCallback,
    ProgressCallback,
)
from .images import (
    get_current_timestamp,
    image_to_tensor,
    largest_factor_near_sqrt,
    make_image_grid,
    tensor_to_image,
)

__all__ = [
    "ExperimentConfig",
    "load_config",
    "dump_config",
    "parse_structured",
    "register_resolver",
    "Configurable",
    "Updateable",
    "BaseObject",
    "update_if_possible",
    "C",
    "TimeRecorder",
    "time_recorder",
    "device_memory_stats",
    "get_rank",
    "find",
    "load_checkpoint",
    "save_checkpoint",
    "get_logger",
    "set_verbosity",
    "SaverMixin",
    "annotate",
    "check_finite",
    "debug_nans",
    "trace",
    "CodeSnapshotCallback",
    "ConfigSnapshotCallback",
    "ProgressCallback",
    "tensor_to_image",
    "image_to_tensor",
    "largest_factor_near_sqrt",
    "make_image_grid",
    "get_current_timestamp",
]
