"""Hierarchical library logger with env-var verbosity control (PyTorch
counterpart of ``worldrenderer_tpu/utils/logging.py``).

An HF-diffusers-style per-library logger under ``worldrenderer_tpu_torch``,
``WORLDRENDERER_VERBOSITY`` env control, progress-bar toggles, and
rank-zero gating: records are emitted only on rank 0 (the ``RANK`` /
``SLURM_PROCID`` env vars, else ``torch.distributed``'s rank once a
process group is up).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Optional

__all__ = [
    "get_logger",
    "get_verbosity",
    "set_verbosity",
    "set_verbosity_debug",
    "set_verbosity_info",
    "set_verbosity_warning",
    "set_verbosity_error",
    "disable_default_handler",
    "enable_default_handler",
    "add_handler",
    "remove_handler",
    "disable_propagation",
    "enable_propagation",
    "enable_explicit_format",
    "reset_format",
    "get_log_levels_dict",
    "disable_progress_bar",
    "enable_progress_bar",
    "is_progress_bar_enabled",
]

_lock = threading.Lock()
_default_handler: Optional[logging.Handler] = None
_progress_bar_enabled = True

_LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}
_DEFAULT_LEVEL = logging.WARNING
_ENV_VAR = "WORLDRENDERER_VERBOSITY"

_ROOT_NAME = "worldrenderer_tpu_torch"


def _get_default_level() -> int:
    env = os.getenv(_ENV_VAR)
    if env:
        if env.lower() in _LOG_LEVELS:
            return _LOG_LEVELS[env.lower()]
        logging.getLogger().warning(
            f"Unknown {_ENV_VAR}={env}, must be one of {list(_LOG_LEVELS)}"
        )
    return _DEFAULT_LEVEL


def _root_logger() -> logging.Logger:
    return logging.getLogger(_ROOT_NAME)


def _configure_root() -> None:
    global _default_handler
    with _lock:
        if _default_handler is not None:
            return
        _default_handler = logging.StreamHandler(sys.stderr)
        _default_handler.setFormatter(
            logging.Formatter("[%(levelname)s|%(name)s] %(message)s")
        )
        root = _root_logger()
        root.addHandler(_default_handler)
        root.setLevel(_get_default_level())
        root.propagate = False


class _RankZeroFilter(logging.Filter):
    """Emit records only on process 0: the env's rank, else the process
    group's when one is initialized."""

    def filter(self, record: logging.LogRecord) -> bool:
        rank = os.environ.get("RANK") or os.environ.get("SLURM_PROCID")
        if rank is not None:
            return int(rank) == 0
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Get a child of the library root logger; inherits the library
    verbosity and the rank-zero filter."""
    _configure_root()
    if name is None or name == _ROOT_NAME:
        logger = _root_logger()
    else:
        if not name.startswith(_ROOT_NAME):
            name = f"{_ROOT_NAME}.{name}"
        logger = logging.getLogger(name)
    if not any(isinstance(f, _RankZeroFilter) for f in logger.filters):
        logger.addFilter(_RankZeroFilter())
    return logger


def get_verbosity() -> int:
    _configure_root()
    return _root_logger().getEffectiveLevel()


def set_verbosity(verbosity) -> None:
    _configure_root()
    if isinstance(verbosity, str):
        verbosity = _LOG_LEVELS[verbosity.lower()]
    _root_logger().setLevel(verbosity)


def set_verbosity_debug() -> None:
    set_verbosity(logging.DEBUG)


def set_verbosity_info() -> None:
    set_verbosity(logging.INFO)


def set_verbosity_warning() -> None:
    set_verbosity(logging.WARNING)


def set_verbosity_error() -> None:
    set_verbosity(logging.ERROR)


def get_log_levels_dict() -> dict:
    return dict(_LOG_LEVELS)


def disable_default_handler() -> None:
    """Detach the library's stderr handler (keep custom handlers active)."""
    _configure_root()
    assert _default_handler is not None
    _root_logger().removeHandler(_default_handler)


def enable_default_handler() -> None:
    _configure_root()
    assert _default_handler is not None
    root = _root_logger()
    if _default_handler not in root.handlers:
        root.addHandler(_default_handler)


def add_handler(handler: logging.Handler) -> None:
    """Attach a custom handler to the library root logger."""
    _configure_root()
    assert handler is not None
    _root_logger().addHandler(handler)


def remove_handler(handler: logging.Handler) -> None:
    _configure_root()
    assert handler is not None and handler in _root_logger().handlers
    _root_logger().removeHandler(handler)


def disable_propagation() -> None:
    _configure_root()
    _root_logger().propagate = False


def enable_propagation() -> None:
    """Let library records also flow to the process root logger. Pair with
    ``disable_default_handler`` to avoid double logging."""
    _configure_root()
    _root_logger().propagate = True


def enable_explicit_format() -> None:
    """Timestamped explicit format on every current library handler."""
    _configure_root()
    fmt = logging.Formatter(
        "[%(levelname)s|%(filename)s:%(lineno)s] %(asctime)s >> %(message)s"
    )
    for handler in _root_logger().handlers:
        handler.setFormatter(fmt)


def reset_format() -> None:
    _configure_root()
    default_fmt = logging.Formatter("[%(levelname)s|%(name)s] %(message)s")
    for handler in _root_logger().handlers:
        handler.setFormatter(
            default_fmt if handler is _default_handler else None
        )


def disable_progress_bar() -> None:
    global _progress_bar_enabled
    _progress_bar_enabled = False


def enable_progress_bar() -> None:
    global _progress_bar_enabled
    _progress_bar_enabled = True


def is_progress_bar_enabled() -> bool:
    return _progress_bar_enabled
