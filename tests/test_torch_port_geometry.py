"""The PyTorch port's foundations against the JAX package: camera,
transforms, mesh, device resolution, config, state carry-over and import
hygiene. Inputs are made with numpy and handed to both packages."""

import ast
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu as wr
from worldrenderer_tpu import mesh as jmesh
from worldrenderer_tpu.ops.rasterize import RasterizerConfig as JConfig
from worldrenderer_tpu.ops.rasterize import FAST_TPU_CONFIG as J_FAST
from worldrenderer_tpu.transforms import (
    get_clip_space_position as j_clip,
    transform_points_homo as j_transform,
)

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch import _device
from worldrenderer_tpu_torch.ops import gbuffer_cuda
from worldrenderer_tpu_torch.ops import rasterize as prast

REPO = Path(__file__).resolve().parent.parent
CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(elevation_deg=35.0, distance=3.0, fovy_deg=50.0, num_views=6,
             near=0.1, far=10.0),
        dict(elevation_deg=[10.0, 20.0, 80.0], distance=[2.0, 2.5, 4.0],
             fovy_deg=40.0, azimuth_deg=[0.0, 123.0, 271.5], near=0.01,
             far=100.0, aspect_wh=1.5),
    ],
)
def test_get_camera_matches_jax(kwargs):
    jc = wr.get_camera(**kwargs)
    pc = pt.get_camera(**kwargs, device="cpu")
    assert len(pc) == len(jc)
    for f in CAM_FIELDS:
        np.testing.assert_allclose(
            _np(getattr(pc, f)), _np(getattr(jc, f)), rtol=1e-5, atol=1e-6,
            err_msg=f,
        )
    # view slicing keeps every field
    sl = pc[1:3]
    assert len(sl) == 2 and sl.cam_pos.shape == (2, 3)


def test_projection_and_orthogonal_camera_match_jax():
    for fovy, aspect in ((50.0, 1.0), ([30.0, 60.0], 0.75)):
        np.testing.assert_allclose(
            _np(pt.camera.get_projection_matrix(fovy, aspect, 0.1, 10.0)),
            _np(wr.camera.get_projection_matrix(fovy, aspect, 0.1, 10.0)),
            rtol=1e-6,
        )
    jc = wr.camera.get_orthogonal_camera(30.0, 2.0, -1, 1, -1, 1, num_views=4)
    pc = pt.get_orthogonal_camera(30.0, 2.0, -1, 1, -1, 1, num_views=4,
                                  device="cpu")
    for f in CAM_FIELDS:
        np.testing.assert_allclose(
            _np(getattr(pc, f)), _np(getattr(jc, f)), rtol=1e-5, atol=1e-6,
            err_msg=f,
        )


def test_affine_inverse_matches_jax(rng):
    mat = np.zeros((5, 4, 4), np.float32)
    mat[:, :3, :] = rng.standard_normal((5, 3, 4)).astype(np.float32)
    mat[:, 3, 3] = 1.0
    np.testing.assert_allclose(
        _np(pt.affine_inverse(torch.from_numpy(mat))),
        _np(wr.camera.affine_inverse(jnp.asarray(mat))),
        rtol=1e-4, atol=1e-5,
    )


def test_clip_space_position_matches_jax(rng):
    verts = rng.standard_normal((500, 3)).astype(np.float32)
    mvp = _np(wr.get_camera(elevation_deg=20.0, distance=3.0, fovy_deg=45.0,
                            num_views=3).mvp_mtx)
    ours = pt.get_clip_space_position(torch.from_numpy(verts),
                                      torch.from_numpy(mvp))
    np.testing.assert_allclose(
        _np(ours), _np(j_clip(jnp.asarray(verts), jnp.asarray(mvp))),
        rtol=1e-6, atol=1e-6,
    )
    # Bit for bit the reference's per-view corner product on the fused
    # G-buffer path (ops/gbuffer.py:1081): XLA's fp32 FMA chain.
    w4 = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=1).T
    ref = jnp.einsum("bij,jt->bit", jnp.asarray(mvp), jnp.asarray(w4),
                     precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_array_equal(_np(ours).transpose(0, 2, 1), _np(ref))


def _fma_exact_f32(m: float, v: float, a: float) -> float:
    """fp32 fma rounded once to nearest (ties to even), by exact rationals."""
    from fractions import Fraction

    x = Fraction(m) * Fraction(v) + Fraction(a)
    c = np.float32(float(x))
    cands = (np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf)))
    return float(min(cands, key=lambda t: (abs(Fraction(float(t)) - x),
                                           int(t.view(np.int32)) & 1)))


def test_fma_f32_rounds_once(rng):
    from worldrenderer_tpu_torch.transforms import fma_f32

    # 1 + 2^-23 + (2^-24 - 2^-60) lies just below an fp32 midpoint; a
    # float64 sum rounds it onto the midpoint and ties to even go up.
    m = np.float32(2.0**-24 * (1 + 2.0**-18))
    v = np.float32(1 - 2.0**-18)
    a = np.float32(1 + 2.0**-23)
    cases = [(m, v, a)] + [
        tuple(np.float32(t) for t in rng.standard_normal(3) * [1, s, 1])
        for s in (1e-3, 1.0, 1e3) for _ in range(100)
    ]
    arr = torch.tensor(cases, dtype=torch.float32).double()
    got = fma_f32(arr[:, 0], arr[:, 1], arr[:, 2])
    want = [_fma_exact_f32(float(p), float(q), float(r)) for p, q, r in cases]
    np.testing.assert_array_equal(got.numpy(), np.float32(want))
    assert float((arr[0, 0] * arr[0, 1] + arr[0, 2]).float()) != want[0]


def test_transform_points_homo_matches_jax(rng):
    pts = rng.standard_normal((2, 7, 5, 3)).astype(np.float32)
    mtx = _np(wr.get_camera(elevation_deg=20.0, distance=3.0, fovy_deg=45.0,
                            num_views=2).w2c)
    np.testing.assert_allclose(
        _np(pt.transform_points_homo(torch.from_numpy(pts),
                                     torch.from_numpy(mtx))),
        _np(j_transform(jnp.asarray(pts), jnp.asarray(mtx))),
        rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("shape", ["icosphere", "grid", "uv_sphere"])
def test_mesh_generators_and_normals_match_jax(shape):
    if shape == "icosphere":
        jv, jf = jmesh.icosphere(3)
        pv, pf = pt.icosphere(3)
    elif shape == "grid":
        fn = lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y)  # noqa: E731
        jv, jf = jmesh.make_grid_mesh(40, height_fn=fn)
        pv, pf = pt.make_grid_mesh(40, height_fn=fn)
    else:
        jv, jf, juv = jmesh.uv_sphere_mesh(17, 33)
        pv, pf, puv = pt.uv_sphere_mesh(17, 33)
        np.testing.assert_array_equal(puv, juv)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jf)
    v32 = pv.astype(np.float32)
    ref = jmesh.compute_vertex_normals(jnp.asarray(v32), jnp.asarray(pf, jnp.int32))
    ours = pt.compute_vertex_normals(torch.from_numpy(v32), torch.from_numpy(pf))
    # Summation order differs (XLA's gather-sum vs the corner-list order):
    # fp32 round-off.
    np.testing.assert_allclose(_np(ours), _np(ref), atol=1e-6)
    m = pt.with_normals(pt.mesh_from_arrays(v32, pf, device="cpu"))
    np.testing.assert_array_equal(_np(m.v_nrm), _np(ours))


@pytest.mark.parametrize("shape", ["icosphere", "grid", "uv_sphere"])
def test_vertex_sums_follow_index_add_order(shape, rng):
    # The fixed-order sum behind the vertex normals equals three sequential
    # index_add_ calls (the CPU's order) bit for bit, at mixed magnitudes.
    from worldrenderer_tpu_torch.mesh import _sum_to_vertices

    if shape == "icosphere":
        v, f = pt.icosphere(3)
    elif shape == "grid":
        v, f = pt.make_grid_mesh(40)
    else:
        v, f = pt.uv_sphere_mesh(17, 33)[:2]
    faces = torch.from_numpy(f).long()
    vals = torch.from_numpy(
        (rng.standard_normal((len(f), 3))
         * 10.0 ** rng.integers(-4, 4, (len(f), 1))).astype(np.float32))
    want = torch.zeros((len(v), 3))
    for k in range(3):
        want.index_add_(0, faces[:, k], vals)
    got = _sum_to_vertices(vals, faces, len(v))
    assert torch.equal(got, want)
    # So the vertex normals equal the index_add_ formula on the CPU.
    v32 = torch.from_numpy(v.astype(np.float32))
    fn = torch.linalg.cross(v32[faces[:, 1]] - v32[faces[:, 0]],
                            v32[faces[:, 2]] - v32[faces[:, 0]])
    acc = torch.zeros_like(v32)
    for k in range(3):
        acc.index_add_(0, faces[:, k], fn)
    acc = torch.where((acc * acc).sum(-1, keepdim=True) > 1e-20, acc,
                      torch.tensor([0.0, 0.0, 1.0]))
    assert torch.equal(pt.compute_vertex_normals(v32, faces),
                       pt.normalize(acc))


def test_normalize_rows_matches_normalize(rng):
    # The device-independent row normalize behind the vertex normals has
    # the bits of normalize on the CPU and of the JAX package's normalize.
    from worldrenderer_tpu.camera import normalize as j_normalize
    from worldrenderer_tpu_torch.mesh import _normalize_rows

    rows = (rng.standard_normal((20000, 3))
            * 10.0 ** rng.integers(-6, 6, (20000, 1))).astype(np.float32)
    got = _normalize_rows(torch.from_numpy(rows))
    assert torch.equal(got, pt.normalize(torch.from_numpy(rows)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_normalize(jnp.asarray(rows))))


def test_normalize_takes_the_reference_keywords():
    """``normalize(x, axis=...)`` as the JAX package names it, with ``dim``
    kept as an alias."""
    from worldrenderer_tpu.camera import normalize as j_normalize

    x = np.array([[3.0, 0.0], [4.0, 1.0]], np.float32)
    want = np.asarray(j_normalize(jnp.asarray(x), axis=0))
    np.testing.assert_allclose(want, [[0.6, 0.0], [0.8, 1.0]], rtol=1e-6)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(pt.normalize(t, axis=0).numpy(), want)
    np.testing.assert_array_equal(pt.normalize(t, dim=0).numpy(), want)
    np.testing.assert_array_equal(
        pt.normalize(t, axis=-1, eps=1e-12).numpy(),
        np.asarray(j_normalize(jnp.asarray(x), axis=-1, eps=1e-12)))


def test_quantized_texture_registry_takes_arr():
    """``register_quantized_texture(arr=...)`` and
    ``is_registered_quantized_texture(arr=...)``, the reference's keyword."""
    tex = torch.zeros((4, 4, 3))
    pt.register_quantized_texture(arr=tex)
    assert pt.is_registered_quantized_texture(arr=tex)
    assert not pt.is_registered_quantized_texture(arr=tex.clone())


def test_to_int32_sat_matches_xla():
    vals = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.5, -2.5,
                     2.0**31, -(2.0**31), 2147483520.0], np.float32)
    ref = np.asarray(jnp.asarray(vals).astype(jnp.int32))
    np.testing.assert_array_equal(_np(_device.to_int32_sat(torch.from_numpy(vals))), ref)


def test_config_matches_jax():
    assert prast.RasterizerConfig._fields == JConfig._fields
    assert tuple(prast.RasterizerConfig()) == tuple(JConfig())
    assert tuple(pt.FAST_TPU_CONFIG) == tuple(J_FAST)
    cfg = pt.config_from_dict(J_FAST._asdict())
    assert cfg == pt.FAST_TPU_CONFIG
    with pytest.raises(ValueError):
        pt.config_from_dict({"tile_h": 16, "not_a_field": 1})


def test_resolve_backend():
    # Every JAX backend name is accepted (one config drives both packages);
    # the route is chosen by device in the kernel wrapper, not by name.
    for name in ("auto", "fused_pallas", "fused_xla", "vpu_pallas", "pallas",
                 "xla"):
        prast._check_ported(prast.RasterizerConfig(backend=name))
    for name in ("cuda", "torch", "bogus"):
        with pytest.raises(ValueError):
            prast._check_ported(prast.RasterizerConfig(backend=name))


def test_convert_carries_jax_state():
    jc = wr.get_camera(elevation_deg=20.0, distance=3.0, fovy_deg=45.0,
                       num_views=2)
    pc = pt.camera_from_arrays(*(np.asarray(getattr(jc, f)) for f in CAM_FIELDS),
                               device="cpu")
    for f in CAM_FIELDS:
        np.testing.assert_array_equal(_np(getattr(pc, f)), _np(getattr(jc, f)))
    v, f = jmesh.icosphere(1)
    m = pt.mesh_from_arrays(v, f, v_tex=v[:, :2], t_tex_idx=f, device="cpu")
    assert m.v_pos.dtype == torch.float32 and m.t_pos_idx.dtype == torch.int64
    assert m.num_faces == f.shape[0] and m.v_tex.shape == (v.shape[0], 2)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.get_camera(elevation_deg=20.0, distance=3.0, fovy_deg=45.0)
    v, f = pt.make_grid_mesh(48)
    mesh = pt.mesh_from_arrays(v, f, device="cpu")
    cam = pt.get_camera(elevation_deg=30.0, distance=3.0, fovy_deg=45.0,
                        device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.render(mesh, cam, 64, 64, render_attr=False)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.rasterize_gbuffer(pos, mesh.t_pos_idx, None, (64, 64))
    tex = torch.rand(1, 8, 8, 3)
    uv = torch.rand(1, 4, 4, 2)
    rast = torch.zeros(1, 4, 4, 4)
    for call in (lambda: pt.texture(tex, uv),
                 lambda: pt.texture_construct_mip(tex),
                 lambda: pt.antialias(tex[:, :4, :4], rast)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert pt.texture(tex, uv, device="cpu").device.type == "cpu"
    assert len(pt.texture_construct_mip(tex, device="cpu")) == 3
    assert pt.antialias(tex[:, :4, :4], rast, device="cpu").shape == (1, 4, 4, 3)
    before = gbuffer_cuda.launch_count
    out = pt.render(mesh, cam, 64, 64, render_attr=False, device="cpu")
    assert out.mask.device.type == "cpu" and out.mask.any()
    assert gbuffer_cuda.launch_count == before  # the CPU path does not launch


def test_unported_options_raise():
    # No RasterizerConfig value raises any more: sub-tile banding
    # (bin_subtile=2) renders equal to 1 on the flat path, below it and on
    # the classic branch, and so does the sub-pixel sort path (at scale it
    # takes the tiny triangles; below the flat path and on the classic
    # branch below it, bin_tiny_px does nothing).
    v, f = pt.make_grid_mesh(48)
    mesh = pt.mesh_from_arrays(v, f, device="cpu")
    cam = pt.get_camera(elevation_deg=30.0, distance=3.0, fovy_deg=45.0,
                        device="cpu")
    small = pt.mesh_from_arrays(*pt.icosphere(1), device="cpu")
    assert mesh.num_faces >= 4096 > small.num_faces
    for m in (mesh, small):
        for backend in ("auto", "xla"):
            # 32x32 tiles: the plain tile passes scan 1,024 pixels, not
            # the default tile's 4,096.
            base = pt.RasterizerConfig(backend=backend, tile_w=32)
            off = pt.render(m, cam, 32, 32, render_attr=False, device="cpu",
                            raster_config=base)
            banded = pt.render(m, cam, 32, 32, render_attr=False,
                               device="cpu",
                               raster_config=base._replace(bin_subtile=2))
            for a, b in zip(banded, off):
                assert (a is None) == (b is None)
                assert a is None or torch.equal(a, b)
            on = pt.render(m, cam, 32, 32, render_attr=False, device="cpu",
                           raster_config=base._replace(bin_tiny_px=1.0))
            assert on.mask.any()
            assert torch.equal(on.mask, off.mask)
            torch.testing.assert_close(on.normal, off.normal, atol=5e-4, rtol=0)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "worldrenderer_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "worldrenderer_tpu"), (
                f"{os.path.relpath(path, REPO)} imports {name}"
            )
