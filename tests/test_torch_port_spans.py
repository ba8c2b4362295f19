"""The program's spans and counters (``utils/debug.py``) on the render path
and the bake, on the CPU at small sizes: off without a profiler, every
stage's span under ``debug.trace`` with its nesting, host-read counters
that repeat exactly, and the same outputs with the profiler on and off."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch.baking import camera_projection
from worldrenderer_tpu_torch.mesh import make_grid_mesh, uv_sphere_mesh
from worldrenderer_tpu_torch.utils import debug

from test_torch_kernel_designs import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RENDER_SPANS = ["wr::render", "wr::raster.setup", "wr::mesh.normals",
                "wr::raster.bin", "wr::raster.chunks", "wr::raster.resolve",
                "wr::interpolate", "wr::texture", "wr::render.finish"]
BAKE_SPANS = ["wr::bake", "wr::bake.validate_binning", "wr::bake.uv_precompute",
              "wr::bake.view_geometry", "wr::bake.gather_geometry",
              "wr::bake.gather_images", "wr::bake.blend", "wr::bake.padding",
              "wr::bake.poisson"]
# (span, the span it lies in)
RENDER_NESTING = [(s, "wr::render") for s in RENDER_SPANS[1:]] + [
    ("wr::mesh.normals", "wr::raster.setup")]
BAKE_NESTING = [(s, "wr::bake") for s in BAKE_SPANS[1:]] + [
    ("wr::render", "wr::bake.view_geometry"), ("wr::k1", "wr::bake")]
# K1 runs in the atlas pass and in the view renders.
BAKE_K1_IN = ("wr::bake.uv_precompute", "wr::render")


def _heightfield(n):
    """An (n x n)-vertex heightfield with planar UVs and a smooth texture,
    no normals (the render computes them)."""
    verts, faces = make_grid_mesh(n, 1.0, lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y))
    uv = (verts[:, :2] + 1.0) / 2.0
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    tex = np.stack([xx, yy, 0.5 + 0.5 * np.sin(9 * xx * yy)], -1).astype(np.float32)
    return pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                               texture=tex, device="cpu")


def _cameras(n):
    return pt.get_camera(elevation_deg=[35.0] * n, distance=[2.6] * n,
                         fovy_deg=[50.0] * n, azimuth_deg=list(range(10, 10 + 30 * n, 30)),
                         num_views=n, near=0.1, far=10.0, device="cpu")


# backend, grid side (47 gives the flat path its 4,232 >= 4,096 triangles),
# views, kernel
RENDER_CASES = [("pallas", 47, 2, "wr::k1"), ("xla", 47, 1, "wr::k2"),
                ("pallas", 20, 2, "wr::k4")]


def _render(mesh, backend, views=2):
    return pt.render(mesh, _cameras(views), 64, 64, render_attr=True,
                     render_depth=True, render_normal=True,
                     depth_normalization_strategy=pt.SimpleNormalization(),
                     raster_config=pt.RasterizerConfig(backend=backend),
                     device="cpu")


def _bake_inputs():
    verts, faces, uv = uv_sphere_mesh(33, 65, 0.5)  # 4,096 triangles
    mesh = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                               texture=np.zeros((64, 64, 3), np.float32),
                               device="cpu")
    cam = pt.get_camera(elevation_deg=[10.0, 20.0, -10.0], distance=[2.0] * 3,
                        fovy_deg=[40.0] * 3, azimuth_deg=[0.0, 120.0, 240.0],
                        num_views=3, near=0.1, far=10.0, device="cpu")
    images = np.random.default_rng(5).random((3, 48, 48, 3)).astype(np.float32)
    return images, mesh, cam


def _bake(validate_binning=True, poisson=True):
    images, mesh, cam = _bake_inputs()
    return camera_projection(
        torch.from_numpy(images), mesh, cam=cam, uv_size=64,
        iou_rejection_threshold=None, poisson_blending=poisson, pb_num_iters=3,
        from_scratch=True, raster_config=pt.RasterizerConfig(backend="pallas"),
        validate_binning=validate_binning, device="cpu")


def _same(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


def test_spans_without_a_profiler_enter_no_range(monkeypatch):
    """No profiler: a span is the shared no-op, enters no
    ``record_function`` and leaves the log empty; counters still count."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    debug.reset_spans()
    before = debug.counter_totals()
    out = _render(_heightfield(47), "pallas")
    assert out.mask.any()
    assert debug.annotate("wr::x") is debug.annotate("wr::y")
    assert debug.span_totals() == {}
    after = debug.counter_totals()
    assert after.get("host_sync.vertex_sum", 0) > before.get("host_sync.vertex_sum", 0)


def _events(d):
    events = json.loads((Path(d) / "trace.json").read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("wr::")]


def _inside(child, parent):
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def _check_nesting(events, nesting, root):
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    for child, parent in nesting:
        assert by.get(child), child
        assert all(any(_inside(c, p) for p in by[parent]) for c in by[child]), \
            (child, parent)
    # The root lies inside no other span.
    others = [e for e in events if e["name"] != root]
    assert not any(_inside(r, o) for r in by[root] for o in others)


@pytest.mark.parametrize("backend,n,views,kernel", RENDER_CASES)
def test_render_spans_nest_under_the_render(tmp_path, backend, n, views, kernel):
    """Each stage of a classic render writes its span into trace.json and
    spans.json, nested as listed, with the kernel's span inside the
    render; the outputs are those of the same render without the
    profiler."""
    mesh = _heightfield(n)
    plain = _render(mesh, backend, views)
    with debug.trace(str(tmp_path)) as d:
        traced = _render(mesh, backend, views)
    _same(plain, traced)
    totals = json.loads((Path(d) / "spans.json").read_text())
    assert set(RENDER_SPANS + [kernel]) <= set(totals)
    assert totals["wr::render"]["calls"] == 1
    assert all(v["stream_ms"] is None for v in totals.values())  # no card
    assert totals["wr::render"]["host_ms"] >= totals[kernel]["host_ms"] > 0
    # Counted syncs go to the render, which holds all of its stages'.
    syncs = {k: v for k, v in totals["wr::render"]["counters"].items()
             if k.startswith("host_sync.")}
    assert syncs.get("host_sync.vertex_sum") == 3
    _check_nesting(_events(d), RENDER_NESTING + [(kernel, "wr::render")],
                   "wr::render")


def test_k3_span_over_rasterize_gbuffer(tmp_path):
    verts, faces = make_grid_mesh(20, 1.0)
    cam = _cameras(1)
    pos = pt.get_clip_space_position(torch.as_tensor(verts, dtype=torch.float32),
                                     cam.mvp_mtx)
    with debug.trace(str(tmp_path)) as d:
        pt.rasterize_gbuffer(pos, torch.as_tensor(faces), None, (32, 64),
                             pt.RasterizerConfig(backend="vpu_pallas"),
                             device="cpu")
    assert "wr::k3" in json.loads((Path(d) / "spans.json").read_text())


def test_bake_spans_nest_under_the_bake(tmp_path):
    """Each stage of camera_projection writes its span, nested under
    ``wr::bake`` (its view renders' spans under ``wr::render``), Poisson
    counts its sweeps, and the bake is the same without the profiler."""
    plain = _bake()
    with debug.trace(str(tmp_path)) as d:
        traced = _bake()
    _same(plain, traced)
    totals = json.loads((Path(d) / "spans.json").read_text())
    # The view renders sample no texture.
    assert set(BAKE_SPANS + RENDER_SPANS + ["wr::k1"]) - set(totals) == {"wr::texture"}
    assert totals["wr::bake"]["calls"] == 1
    assert totals["wr::bake.poisson"]["counters"] == {"poisson.sweeps": 3}
    assert totals["wr::bake"]["counters"]["poisson.sweeps"] == 3
    events = _events(d)
    _check_nesting(events, BAKE_NESTING, "wr::bake")
    for parent in BAKE_K1_IN:
        assert any(_inside(c, p) for c in events if c["name"] == "wr::k1"
                   for p in events if p["name"] == parent), parent


def _bake_totals(**kw):
    debug.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _bake(**kw)
    return debug.span_totals()


def test_bake_host_reads_repeat_exactly():
    """The binning guard's reads count with ``validate_binning`` and not
    without, and the guard holds every count the two bakes differ by; two
    identical bakes count the same."""
    on = _bake_totals(validate_binning=True, poisson=False)
    off = _bake_totals(validate_binning=False, poisson=False)["wr::bake"]["counters"]
    guard = on["wr::bake.validate_binning"]["counters"]
    assert guard["host_sync.binning_stats"] > 0
    assert "host_sync.binning_stats" not in off
    rest = {k: v - guard.get(k, 0) for k, v in on["wr::bake"]["counters"].items()}
    assert {k: v for k, v in rest.items() if v} == off
    again = _bake_totals(validate_binning=True, poisson=False)
    assert again["wr::bake"]["counters"] == on["wr::bake"]["counters"]
