"""The program's own spans and counters over the traced window, for the
per-layer metrics that read them: ``span_totals()`` of
``worldrenderer_tpu_torch.utils.debug``, which logs a span only while a
profiler runs (the traced window is the run's one profiled stretch).

Every reader returns None where the program keeps no such log (a version
without spans) or logged nothing, and a stream time is None where a span
recorded no CUDA events (off the card)."""

from __future__ import annotations

from typing import Dict, Iterable, Optional


def totals() -> Optional[Dict[str, Dict]]:
    """The program's span totals, or None where it has none."""
    from worldrenderer_tpu_torch.utils import debug

    read = getattr(debug, "span_totals", None)
    if read is None:
        return None
    return read() or None


def stream_ms(names: Iterable[str], per: Optional[float]) -> Optional[float]:
    """The summed stream milliseconds of spans ``names`` over ``per``
    (frames or bakes)."""
    t = totals()
    if t is None or not per:
        return None
    rows = [t[n] for n in names if n in t]
    if not rows or any(r["stream_ms"] is None for r in rows):
        return None
    return sum(r["stream_ms"] for r in rows) / per


def host_ms(name: str, per: Optional[float]) -> Optional[float]:
    """The host milliseconds of span ``name`` over ``per``."""
    t = totals()
    if t is None or not per or name not in t:
        return None
    return t[name]["host_ms"] / per


def host_syncs(name: str, per: Optional[float]) -> Optional[float]:
    """The ``host_sync.*`` counts inside span ``name`` over ``per``."""
    t = totals()
    if t is None or not per or name not in t:
        return None
    return sum(v for k, v in t[name]["counters"].items()
               if k.startswith("host_sync.")) / per
