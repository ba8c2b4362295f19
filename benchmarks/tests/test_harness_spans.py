"""The per-layer metrics that read the program's own spans and counters
(``harness/spans.py``): listed in the manifest without fault, numbers from
a tiny traced run on the CPU (stream times there are None: no card), and
on the card the program's count of host syncs against the synchronising
calls that PyTorch's sync debug mode reports inside its spans."""

import json
import time
import traceback
import warnings

import pytest
import torch

from tinybench import ROOT, need_card
from harness.manifest import Manifest, problems

SPAN_METRICS = {
    "terrain-rerender-classic": ("prep_ms.render", "shade_ms.render",
                                 "issue_ms.render", "host_syncs.render"),
    "tex4k-bake-classic": ("gather_ms.bake", "validate_ms.bake",
                           "issue_ms.bake", "host_syncs.bake"),
}


def test_the_span_metrics_are_listed_without_fault():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert problems(data) == []
    man = Manifest()
    for cell, names in SPAN_METRICS.items():
        listed = {m["name"]: m for m in man.per_layer(cell)}
        for n in names:
            assert listed[n]["workloads"] == [cell]
            assert callable(man.metric_reader(n))


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_tiny_traced_run_reads_the_spans(tiny_manifest, cell):
    from harness.cell import run_cell

    res = run_cell(tiny_manifest, tiny_manifest.workload(cell), 2**33 + 41, 0.5,
                   True, "cpu", time.perf_counter())
    assert res["correct"] is True
    got = res["metrics"]
    for n in SPAN_METRICS[cell]:
        if n.startswith(("issue_ms", "host_syncs")):
            assert got[n]["value"] >= 0 and isinstance(got[n]["value"], float)
        else:  # stream times need the card
            assert n not in got
    assert got[SPAN_METRICS[cell][2]]["value"] > 0


def _warned_syncs(request):
    """Run ``request()`` under the profiler (so the program's spans are
    live) with sync debug mode "warn": the synchronising calls made inside
    a ``wr::`` span, by the program's innermost line, and outside any."""
    from worldrenderer_tpu_torch.utils import debug

    inside, outside = {}, {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if "worldrenderer_tpu_torch" in f.filename]
        where = (f"{port[-1].filename.rsplit('/', 1)[-1]}:{port[-1].lineno}"
                 if port else f"{stack[-1].filename}:{stack[-1].lineno}")
        bucket = inside if debug._state.stack() else outside
        bucket[where] = bucket.get(where, 0) + 1

    debug.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                request()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return inside, outside, debug.span_totals()


@pytest.mark.chip
@pytest.mark.parametrize("backend", ["cell", "fused_pallas"])
@pytest.mark.parametrize("cell,root", [("terrain-rerender-classic", "wr::render"),
                                       ("tex4k-bake-classic", "wr::bake")])
def test_counted_host_syncs_are_the_warned_ones(cell, root, backend):
    """One request of each cell, on its configuration's branch and on the
    fused one."""
    need_card()
    from harness.traffic import driver_for

    man = Manifest()
    w = man.workload(cell)
    config = man.config(w["config"])
    if backend != "cell":
        config = dict(config, raster_backend=backend)
    d = driver_for(man, config, man.traffic(w["traffic"]), "cuda")
    d.build()
    d.reseed(2**31 + 77)
    d.warm()
    inside, outside, totals = _warned_syncs(lambda: d.request(1))
    counted = {k: v for k, v in totals[root]["counters"].items()
               if k.startswith("host_sync.")}
    print(f"{cell} ({backend}): warned inside spans {inside}, outside {outside}; "
          f"counted {counted}")
    assert sum(inside.values()) == sum(counted.values())
