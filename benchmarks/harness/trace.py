"""Reading a ``torch.profiler`` Chrome trace of the traced window.

The window is the host span of the ``bench::window`` range that the
harness opens around the traced requests. The card's work is every event
of the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; its busy
time is the union of their intervals inside the window. An idle gap is
named by what the host was doing at its middle: the harness's own
``bench::`` range there and the innermost host operation inside it.
(The union-of-intervals and range arithmetic follows ``chip_smoke.py
stage_split`` and ``worldrenderer_tpu_torch/utils/roofline.py
exclusive_times``, rewritten here for the harness.)
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench::window"
# Gaps shorter than this are not named (they still count as idle).
MIN_NAMED_GAP_US = 2.0


class TraceReading:
    """What the per-layer metrics read from one traced window.

    ``device``: (name, category, start_us, dur_us) of the card's events in
    the window; ``window_us``: (start, end); ``counts``: the harness's
    counts for the window (frames, bakes, requests, ...)."""

    def __init__(self, device: List[Tuple[str, str, float, float]],
                 window_us: Tuple[float, float],
                 gaps: List[Tuple[str, float]], counts: Dict):
        self.device = device
        self.window_us = window_us
        self.gaps = gaps
        self.counts = dict(counts)

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(
            [(s, s + d) for _, _, s, d in self.device])) / 1e6

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [(n, s, d) for n, c, s, d in self.device if c == "kernel"]

    def kernel_seconds(self, substring: Optional[str] = None) -> float:
        return sum(d for n, s, d in self.kernels()
                   if substring is None or substring in n) / 1e6

    def breakdown(self, top: int = 10) -> Dict:
        ops = collections.Counter()
        for n, _, _, d in self.device:
            ops[n[:200]] += d / 1e6
        gaps = collections.Counter()
        for n, s in self.gaps:
            gaps[n[:200]] += s
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def load_events(path: str) -> List[Dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def read_events(events: List[Dict], counts: Dict) -> TraceReading:
    """A ``TraceReading`` of the window in Chrome trace ``events``."""
    windows = [e for e in events if e.get("ph") == "X"
               and e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(windows) != 1:
        raise ValueError(f"expected one {WINDOW} range, found {len(windows)}")
    win = windows[0]
    w0 = float(win["ts"])
    w1 = w0 + float(win["dur"])
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        a, b = max(s, w0), min(s + d, w1)
        if b > a:
            device.append((str(e.get("name", "?")), e["cat"], a, b - a))
    busy = _union([(s, s + d) for _, _, s, d in device])
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    named = _name_gaps(events, win, [(a, b) for a, b in gaps
                                     if b - a >= MIN_NAMED_GAP_US])
    return TraceReading(device, (w0, w1), named, counts)


def _name_gaps(events, win, gaps):
    """[(name, seconds)] of each gap: the ``bench::`` range and the
    innermost host operation on the window's thread at the gap's middle."""
    if not gaps:
        return []
    lane = (win.get("pid"), win.get("tid"))
    host = sorted(
        (float(e["ts"]), -float(e.get("dur", 0.0)), str(e.get("name", "?")))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in HOST_CATS
        and (e.get("pid"), e.get("tid")) == lane and e is not win)
    starts = [h[0] for h in host]
    out = []
    stack: List[Tuple[float, str]] = []  # (end, name), nested
    i = 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        j = bisect.bisect_right(starts, mid)
        for ts, neg_dur, name in host[i:j]:
            while stack and stack[-1][0] <= ts:
                stack.pop()
            stack.append((ts - neg_dur, name))
        i = max(i, j)
        while stack and stack[-1][0] <= mid:
            stack.pop()
        outer = next((n for _, n in stack if n.startswith("bench::")), "host")
        inner = stack[-1][1] if stack else "idle"
        out.append((f"{outer} / {inner}" if inner != outer else outer,
                    (b - a) / 1e6))
    return out
