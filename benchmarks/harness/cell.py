"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference after the window has closed."""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from . import check
from .manifest import Manifest
from .traffic import Driver, driver_for

FORBIDDEN = ("jax", "jaxlib", "flax", "worldrenderer_tpu")


def forbidden_modules(modules: Dict) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared as whole names."""
    return sorted(n for n in modules if n.split(".")[0] in FORBIDDEN)


class Record:
    __slots__ = ("k", "t_issue", "t_done", "work", "failed")

    def __init__(self, k, t_issue, t_done, work, failed):
        self.k, self.t_issue, self.t_done = k, t_issue, t_done
        self.work, self.failed = work, failed


def run_window(driver: Driver, seconds: float, keep, max_requests: Optional[int] = None):
    """Closed loop: issue request k, wait for it, issue k + 1, until
    ``seconds`` have passed since the first issue (or ``max_requests``).
    Returns (records, t0, t_end): t_end is the last completion."""
    records: List[Record] = []
    t0 = time.perf_counter()
    k = 0
    while True:
        t_issue = time.perf_counter()
        if t_issue - t0 >= seconds or (max_requests and k >= max_requests):
            break
        try:
            with torch.profiler.record_function("bench::request"):
                out = driver.request(k)
            failed = False
        except Exception as e:  # a request that fails counts, the run goes on
            print(f"request {k} failed: {type(e).__name__}: {e}", file=sys.stderr)
            out, failed = None, True
        t_done = time.perf_counter()
        records.append(Record(k, t_issue, t_done, driver.work(k), failed))
        if not failed:
            keep(k, out)
        k += 1
    t_end = records[-1].t_done if records else t0
    return records, t0, t_end


class Window(NamedTuple):
    """What an end-to-end metric's reader reads: the window's requests,
    its first issue and last completion, and the set-up before it."""
    records: List[Record]
    t0: float
    t_end: float
    setup_s: float


def power_limit() -> Optional[str]:
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def run_cell(manifest: Manifest, cell: Dict, seed: int, seconds: float,
             trace: bool, device: str, setup_started: float,
             driver_hook: Optional[Callable[[Driver], None]] = None) -> Dict:
    """One run. ``setup_started``: ``time.perf_counter()`` at process start.
    ``driver_hook`` (tests) may replace the driver's program calls."""
    config = manifest.config(cell["config"])
    mix = manifest.traffic(cell["traffic"])
    spec = manifest.checks(cell["name"])
    kind = manifest.kind(mix["kind"])
    cuda = torch.device(device).type == "cuda"
    driver = driver_for(manifest, config, mix, device)
    if driver_hook is not None:
        driver_hook(driver)
    driver.build()
    driver.reseed(seed)
    driver.warm()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    sampler = driver.sampler(seed)
    setup_s = time.perf_counter() - setup_started

    reading = None
    if trace:
        reading, records, t0, t_end = _traced_window(driver, mix, seconds,
                                                     sampler.offer)
    else:
        records, t0, t_end = run_window(driver, seconds, sampler.offer)
    if cuda:
        torch.cuda.synchronize()
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0

    failed = sum(r.failed for r in records)
    metrics: Dict[str, Dict] = {}
    if trace:
        if cuda and hasattr(kind, "trace_counts"):
            extra = kind.trace_counts(driver, records)
            print(f"trace counts: {extra}", file=sys.stderr)
            reading.counts.update(extra)
        reading.counts["mem_peak_bytes"] = mem_peak
        listed, source = manifest.per_layer(cell["name"]), reading
    else:
        listed = manifest.end_to_end(cell["name"])
        source = Window(records, t0, t_end, setup_s)
    for m in listed:
        v = manifest.metric_reader(m["name"])(source)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # The window has closed and the peak is read: free the program's state,
    # then run the reference over the kept requests.
    kept = sampler.kept
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    pairs = ((driver.program_outputs(out), driver.reference(k))
             for k, out in sorted(kept.items()))
    values = check.numbers(kind.counts, pairs, spec)
    correct, report = check.judge(values, spec)
    correct = correct and failed == 0 and bool(records)

    result = {"correct": correct, "attempted": len(records), "failed": failed,
              "metrics": metrics,
              "device": device_info(cuda, mem_peak, reading)}
    if reading is not None:
        result["breakdown"] = reading.breakdown()
    result["checks"] = report
    return result


def device_info(cuda: bool, mem_peak: int, reading) -> Dict:
    if cuda:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": mem_peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": mem_peak}
    if reading is not None:
        info["busy_s"] = reading.busy_s
        info["window_s"] = reading.window_s
    return info


def _traced_window(driver: Driver, mix: Dict, seconds: float, keep):
    """The window under ``torch.profiler``: at most ``trace_requests``
    requests (and ``seconds``), inside one ``bench::window`` range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import load_events, read_events

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench::window"):
            records, t0, t_end = run_window(driver, seconds, keep,
                                            max_requests=mix["trace_requests"])
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = load_events(path)
    counts = {"requests": len(records),
              driver.work_unit: sum(r.work for r in records if not r.failed)}
    return read_events(events, counts), records, t0, t_end
