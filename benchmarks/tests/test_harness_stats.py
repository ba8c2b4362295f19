"""The metric arithmetic on synthetic records and traces."""

import pytest

import tinybench  # noqa: F401
from harness import stats
from harness.cell import Record, Window
from harness.manifest import Manifest
from harness.trace import read_events


def _read(name, recs, t0, t1):
    return Manifest().metric_reader(name)(Window(recs, t0, t1, 12.5))


def test_rate_is_all_work_over_all_time():
    recs = [Record(0, 0.0, 1.0, 16, False), Record(1, 1.0, 3.0, 16, False),
            Record(2, 3.0, 3.5, 16, True)]
    # The failed request's frames are not work; its time is.
    assert _read("frames_per_s", recs, 0.0, 3.5) == pytest.approx(32 / 3.5)
    assert _read("bake_s", recs, 0.0, 3.5) == pytest.approx(3.5 / 2)
    assert _read("setup_s", recs, 0.0, 3.5) == 12.5


def test_p95_is_over_all_requests():
    lat = [0.010] * 95 + [0.100] * 5
    recs = [Record(k, float(k), float(k) + v, 16, False) for k, v in enumerate(lat)]
    assert _read("chunk_p95_ms", recs, 0.0, 200.0) == pytest.approx(
        1e3 * stats.percentile(lat, 95))
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
    assert stats.percentile(list(range(101)), 95) == 95
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_idle_share_and_breakdown_from_a_trace():
    events = [
        _ev("bench::window", "user_annotation", 1000, 100),
        _ev("bench::request", "user_annotation", 1000, 100),
        _ev("aten::sort", "cpu_op", 1010, 20),
        _ev("aten::copy_", "cpu_op", 1060, 30),
        _ev("k_a", "kernel", 990, 20, tid=7),   # half inside the window
        _ev("k_b", "kernel", 1040, 10, tid=7),
        _ev("k_b", "kernel", 1045, 10, tid=7),  # overlaps the one before
        _ev("Memcpy DtoH", "gpu_memcpy", 1080, 5, tid=8),
        _ev("k_late", "kernel", 1200, 10, tid=7),  # after the window
    ]
    r = read_events(events, {"frames": 4})
    assert r.window_s == pytest.approx(100e-6)
    # Busy: [1000, 1010) + [1040, 1055) + [1080, 1085) = 30 us.
    assert r.busy_s == pytest.approx(30e-6)
    assert 100 * (1 - r.busy_s / r.window_s) == pytest.approx(70.0)
    assert r.kernel_seconds() == pytest.approx(30e-6)  # summed, not merged
    assert len(r.kernels()) == 3
    b = r.breakdown()
    assert b["device_ops"][0] == ["k_b", pytest.approx(20e-6)]
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    # [1010, 1040): aten::sort at its middle; [1055, 1080): aten::copy_;
    # [1085, 1100): after the copy, in the request alone.
    assert gaps["bench::request / aten::sort"] == pytest.approx(30e-6)
    assert gaps["bench::request / aten::copy_"] == pytest.approx(25e-6)
    assert gaps["bench::request"] == pytest.approx(15e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        read_events([_ev("k", "kernel", 0, 1)], {})
