"""Numerics debugging and device-trace profiling helpers (PyTorch
counterpart of ``worldrenderer_tpu/utils/debug.py``).

``check_finite`` reads the tensors back to the host, so it is a debugging
aid kept off the main path; ``debug_nans`` is autograd's anomaly mode;
``trace`` writes a ``torch.profiler`` Chrome trace and ``annotate`` names a
span inside it.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator, Optional

import torch

__all__ = ["check_finite", "debug_nans", "trace", "annotate"]


def check_finite(x, name: str = "tensor"):
    """Raise ``FloatingPointError`` when a tensor in ``x`` (a tensor, or a
    dict / list / tuple of them, nested) holds NaN or Inf; return ``x``.
    A host sync per tensor."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise FloatingPointError(f"{name} has non-finite values")
    elif isinstance(x, dict):
        for k, v in x.items():
            check_finite(v, f"{name}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            check_finite(v, f"{name}[{i}]")
    return x


@contextlib.contextmanager
def debug_nans(enabled: bool = True) -> Iterator[None]:
    """Scope with autograd's anomaly detection on: a backward that makes a
    NaN raises, naming the forward op that led to it."""
    with torch.autograd.set_detect_anomaly(enabled):
        yield


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Profile the block with ``torch.profiler`` (host ops, and the card's
    kernels when one is present) and write a Chrome trace,
    ``<log_dir>/trace.json`` (a fresh temporary directory when None).
    Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or tempfile.mkdtemp(prefix="wr_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named span that shows up inside ``trace``'s device traces."""
    return torch.profiler.record_function(name)
