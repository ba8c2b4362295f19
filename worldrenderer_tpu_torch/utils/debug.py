"""Numerics debugging, device-trace profiling, and the program's spans and
counters (PyTorch counterpart of ``worldrenderer_tpu/utils/debug.py``).

``check_finite`` reads the tensors back to the host, so it is a debugging
aid kept off the main path; ``debug_nans`` is autograd's anomaly mode.

Spans and counters. The render path and the bake open a span at each of
their stages (``annotate``) and count their kernel launches and host reads
(``count``):

* ``wr::render`` (one ``render`` call) over ``wr::raster.setup`` (vertex
  normals, the clip transform, triangle setup; ``wr::mesh.normals`` inside
  it), ``wr::raster.bin`` (tile binning), ``wr::raster.chunks`` (chunk
  layout, tile rows, the sub-pixel sort path), ``wr::k1`` .. ``wr::k4``
  (the tile kernels' wrappers), ``wr::raster.resolve`` (detile, merge and
  the (u, v) resolve), ``wr::interpolate``, ``wr::texture`` and
  ``wr::render.finish`` (masks, depth, normals, backgrounds);
* ``wr::bake`` (one ``camera_projection`` call) over
  ``wr::bake.validate_binning``, ``wr::bake.uv_precompute``,
  ``wr::bake.view_geometry``, ``wr::bake.gather_geometry``,
  ``wr::bake.gather_images``, ``wr::bake.blend``, ``wr::bake.padding`` and
  ``wr::bake.poisson``;
* counters ``launch.k1`` .. ``launch.k4`` and ``launch.p1`` .. ``launch.p3``
  (CUDA launches; the plain versions on the CPU count none),
  ``host_sync.<site>`` (each point where the host waits for the card: a
  read of a device value, or a copy from pageable host memory, which
  waits for the stream) and ``poisson.sweeps``.

With no profiler running a span costs one flag check and enters a shared
no-op context. While ``torch.profiler`` runs, a span is a
``record_function`` range (on the host thread and, over the kernels it
launched, on the device row of the trace) and an entry of an in-memory
log: its name, its parent, the sequence number of its outermost span (the
request), its host start and end, and on CUDA a pair of events on the
current stream, resolved only when the log is read. A span never
synchronises the card. ``count`` keeps a process total always and, while
spans are open, adds to the innermost span's entry.

``with trace(dir):`` around any call writes the Chrome trace
``dir/trace.json`` and the per-stage table ``dir/spans.json``
(``span_totals``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["check_finite", "debug_nans", "trace", "annotate", "count",
           "counter_totals", "span_totals", "reset_spans"]


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
    ``<log_dir>/trace.json``, and the block's span totals,
    ``<log_dir>/spans.json`` (the log is emptied on entry; a fresh
    temporary directory when None). Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or tempfile.mkdtemp(prefix="wr_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset_spans()
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(span_totals(), f, indent=1)


# ---- spans and counters ------------------------------------------------------


class _Entry:
    """One span of the log."""

    __slots__ = ("name", "parent", "request", "t0", "t1", "e0", "e1",
                 "counters")

    def __init__(self, name: str, parent: Optional["_Entry"], request: int):
        self.name, self.parent, self.request = name, parent, request
        self.t0 = self.t1 = 0.0
        self.e0 = self.e1 = None
        self.counters: Dict[str, int] = {}


class _Span:
    """A span while a profiler runs: a ``record_function`` range and a log
    entry."""

    __slots__ = ("name", "entry", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _state.stack()
        parent = stack[-1] if stack else None
        request = parent.request if parent else next(_state.requests)
        e = self.entry = _Entry(self.name, parent, request)
        self.range = _autograd_profiler.record_function(self.name)
        self.range.__enter__()
        if torch.cuda.is_initialized():
            e.e0 = torch.cuda.Event(enable_timing=True)
            e.e1 = torch.cuda.Event(enable_timing=True)
            e.e0.record()
        _state.stack().append(e)
        _state.log.append(e)
        e.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        e = self.entry
        e.t1 = time.perf_counter()
        _state.stack().pop()
        if e.e1 is not None:
            e.e1.record()
        self.range.__exit__(*exc)
        return False


class _State:
    """The span log, the open spans of each thread and the counters'
    process totals (one per process: the profiler is too)."""

    def __init__(self):
        self.log: List[_Entry] = []
        self.requests = itertools.count()
        self.totals: Dict[str, int] = {}
        self._local = threading.local()

    def stack(self) -> List[_Entry]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s


_state = _State()
_NO_SPAN = contextlib.nullcontext()


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


def annotate(name: str):
    """The program's span ``name`` (a context manager): a no-op unless a
    profiler runs, then a ``record_function`` range and a log entry (see
    the module's docstring). Never synchronises the card."""
    if not _profiling():
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``: to its process total, and to the
    innermost open span's entry while spans are open."""
    totals = _state.totals
    totals[name] = totals.get(name, 0) + n
    if _profiling():
        stack = _state.stack()
        if stack:
            c = stack[-1].counters
            c[name] = c.get(name, 0) + n


def counter_totals() -> Dict[str, int]:
    """A copy of every counter's process total."""
    return dict(_state.totals)


def reset_spans() -> None:
    """Empty the span log."""
    _state.log.clear()


def span_totals() -> Dict[str, Dict]:
    """Per span name over the log: ``calls``; ``host_ms``, the host's time
    from enter to exit; ``stream_ms``, the current stream's time between
    the span's two events (None where a call recorded none, as off CUDA);
    ``counters``, counted while the span or one nested in it was the
    innermost. Times and counters include nested spans. Waits for the
    spans' end events."""
    out: Dict[str, Dict] = {}

    def row_of(name: str) -> Dict:
        return out.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                     "stream_ms": 0.0, "counters": {}})

    for e in list(_state.log):
        row = row_of(e.name)
        row["calls"] += 1
        row["host_ms"] += 1e3 * (e.t1 - e.t0)
        if e.e1 is None or row["stream_ms"] is None:
            row["stream_ms"] = None
        else:
            e.e1.synchronize()
            row["stream_ms"] += e.e0.elapsed_time(e.e1)
        # Each entry's counters go to its own row and to its ancestors'
        # (a name nested in itself counts once).
        names, p = set(), e
        while p is not None:
            if p.name not in names:
                names.add(p.name)
                c = row_of(p.name)["counters"]
                for k, v in e.counters.items():
                    c[k] = c.get(k, 0) + v
            p = p.parent
    return out
