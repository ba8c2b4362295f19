"""The port's textured slice against the JAX package: vertex tangents, the
split-UV seam cut, and ``render()`` with textured
colour on the fused branch at the flat path (a 4,232-triangle heightfield:
K1's plain version) and below it (a 960-triangle UV sphere: K2's), and on
the classic branch (K4, then ``interpolate``), with tangents,
``antialias_attr``, ``auto_mip``, ``texture_pack_mode`` auto and u8, the
split-UV ``auto`` path, ``ssaa=2`` and ``view_chunk``; the weak-reference
caches. Both packages get the same numpy inputs.

Renders are held against the reference of ``test_torch_port_tiles.py``'s
``reference`` fixture (op by op, its kernels jitted, its clip transform on
padded vertices; that module says why): masks equal, positions and depth
within 1e-5, normals and tangents within 5e-4 (the tolerances
``tests/test_gbuffer.py`` holds the JAX backends to), and colour within
5e-4: the texture is sampled at (u, v) planes that agree to fp32
round-off, and a bilinear tap moves by (u, v)'s error times the texture's
width (512) times its contrast. ``antialias`` on its own is held in
``test_torch_port_texture.py``, beside the sampler (it keeps this file's
JAX compiles within their time)."""

import functools
import gc
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu as wr
import worldrenderer_tpu.ops.rasterize  # noqa: F401
from worldrenderer_tpu import mesh as jmesh
from worldrenderer_tpu.transforms import get_clip_space_position as j_clip

import worldrenderer_tpu_torch as pt
import worldrenderer_tpu_torch.render  # noqa: F401  (sys.modules below)
from worldrenderer_tpu_torch import mesh as pmesh

from test_torch_port_tiles import reference  # noqa: F401  (a fixture)

jr = sys.modules["worldrenderer_tpu.ops.rasterize"]
prender = sys.modules["worldrenderer_tpu_torch.render"]
CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")
SIZE = 128


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _checker(size=512, period=32):
    """bench.py's checker, quantized to k/255."""
    t = (np.indices((size, size)).sum(0) // period % 2).astype(np.float32)
    return (np.round(np.stack([t, 1 - t, t * 0 + 0.5], -1) * 255) / 255).astype(
        np.float32)


def _split(verts, faces, uv, n):
    """bench.py:749-784's split-UV topology on an n x n grid: the middle
    column's UVs duplicated for the faces to its right."""
    col = np.arange(n * n) % n
    mid = np.where(col == n // 2)[0]
    v_tex = np.concatenate([uv, uv[mid]], axis=0)
    alt = np.arange(n * n)
    alt[mid] = n * n + np.arange(mid.size)
    right = col[faces].max(axis=1) > n // 2
    return v_tex, np.where(right[:, None], alt[faces], faces).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(verts, faces, uv, t_tex_idx, camera kwargs) of a scene: ``grid``
    the 4,232-triangle heightfield with planar UVs, ``split`` the same with
    a split-UV seam, ``sphere`` uv_sphere_mesh(16, 33)."""
    if name in ("grid", "split"):
        n = 47
        verts, faces = jmesh.make_grid_mesh(
            n, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y))
        uv = (verts[:, :2] - verts[:, :2].min(0)) / np.ptp(verts[:, :2], 0)
        t_tex = faces
        if name == "split":
            uv, t_tex = _split(verts, faces, uv, n)
        cam = dict(elevation_deg=35.0, distance=3.0, fovy_deg=50.0)
    else:
        verts, faces, uv = jmesh.uv_sphere_mesh(16, 33)
        t_tex = faces
        cam = dict(elevation_deg=20.0, distance=2.7, fovy_deg=40.0)
    return (verts.astype(np.float32), faces.astype(np.int32), uv.astype(np.float32),
            np.asarray(t_tex, np.int32), cam)


@functools.lru_cache(maxsize=None)
def _both(name):
    """JAX mesh and cameras, port mesh and cameras (2 views, the cameras
    built jitted for both packages)."""
    verts, faces, uv, t_tex, cam_kw = _scene(name)
    tex = _checker()
    with jax.disable_jit(False):
        jcam = wr.get_camera(num_views=2, near=0.1, far=10.0, **cam_kw)
    pcam = pt.camera_from_arrays(*(_np(getattr(jcam, f)) for f in CAM_FIELDS),
                                 device="cpu")
    jm = wr.TexturedMesh(v_pos=jnp.asarray(verts), t_pos_idx=jnp.asarray(faces),
                         v_tex=jnp.asarray(uv), t_tex_idx=jnp.asarray(t_tex),
                         texture=jnp.asarray(tex))
    pm = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=t_tex,
                             texture=tex, device="cpu")
    return jm, jcam, pm, pcam


def _config(name, size):
    """The fused scenes' configs: the heightfield's auto_fast_config budgets
    (equal in both packages), its JAX side with exact fp32 dots; the sphere
    at the defaults."""
    if name == "sphere":
        return jr.RasterizerConfig(backend="fused_pallas")
    jm, jcam, pm, pcam = _both("grid")
    jcfg = jr.auto_fast_config(j_clip(jm.v_pos, jcam.mvp_mtx), jm.t_pos_idx,
                               (size, size))
    pcfg = pt.auto_fast_config(pt.get_clip_space_position(pm.v_pos, pcam.mvp_mtx),
                               pm.t_pos_idx, (size, size))
    assert tuple(pcfg) == tuple(jcfg)
    return jcfg._replace(dot_precision="highest")


# Each case: (scene, render kwargs, output size). The JAX renders are
# cached: several port renders are held against one. ``classic_ssaa``
# renders ``classic``'s image inside, whose compiled ops it reuses.
_CASES = {
    "grid": ("grid", dict(render_tangent=True, antialias_attr=True,
                          texture_filter_mode="auto_mip"), SIZE),
    "sphere": ("sphere", dict(render_tangent=True), SIZE),
    "classic": ("sphere", dict(render_tangent=True, antialias_attr=True,
                               backend="pallas"), SIZE),
    "classic_ssaa": ("sphere", dict(render_tangent=True, antialias_attr=True,
                                    backend="pallas", ssaa=2), SIZE // 2),
}


def _render_kw(case, pkg):
    name, kw, size = _CASES[case]
    kw = dict(kw)
    backend = kw.pop("backend", None)
    cfg = _config(name, size * kw.get("ssaa", 1))
    if backend is not None:
        cfg = cfg._replace(backend=backend)
    if pkg == "port":
        cfg = pt.config_from_dict(cfg._asdict())
    return dict(render_attr=True, render_depth=True, render_normal=True,
                raster_config=cfg, **kw)


@functools.lru_cache(maxsize=None)
def _ref_render(case):
    """The reference's render of a case (call it under ``reference``)."""
    name, _, size = _CASES[case]
    jm, jcam, _, _ = _both(name)
    return wr.render(jm, jcam, size, size, **_render_kw(case, "jax"))


def _port_render(case, **over):
    name, _, size = _CASES[case]
    _, _, pm, pcam = _both(name)
    kw = _render_kw(case, "port")
    kw.update(over)
    return pt.render(pm, pcam, size, size, device="cpu", **kw)


_TOL = {"pos": 1e-5, "depth": 1e-5, "normal": 5e-4, "tangent": 5e-4,
        "attr": 5e-4}


def _hold_render(out, ref, float_mask=False):
    m = _np(ref.mask)
    if float_mask:
        np.testing.assert_allclose(_np(out.mask), m, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(_np(out.mask), m)
    assert (m > 0).mean() > 0.2
    for f, atol in _TOL.items():
        want = getattr(ref, f)
        if want is None:
            assert getattr(out, f) is None, f
            continue
        np.testing.assert_allclose(_np(getattr(out, f)), _np(want), rtol=0,
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("case, over", [
    ("grid", {}),
    ("grid", dict(view_chunk=1)),
    ("sphere", {}),
    ("sphere", dict(texture_pack_mode="u8")),
    ("sphere", dict(texture_pack_mode="none")),
    ("classic", {}),
    ("classic_ssaa", {}),
], ids=["fused_flat_tangent_antialias_auto_mip", "fused_flat_view_chunk",
        "fused_per_tile_pack_auto", "fused_per_tile_u8", "fused_per_tile_none",
        "classic_tangent_antialias", "classic_ssaa2"])
def test_textured_render_matches_jax(reference, case, over):
    """Colour, depth, normals and tangents of each case. Pack mode "auto"
    (the default) resolves to "u8" on this 512² k/255 texture in both
    packages (and to "none" under auto_mip), and "u8" is exact for it, so
    the three pack modes and the view chunks are held against one
    reference render."""
    _hold_render(_port_render(case, **over), _ref_render(case),
                 float_mask=case == "classic_ssaa")


def test_split_uv_auto_render_matches_jax(reference):
    """A split-UV mesh under ``backend="auto"``: ``render`` seam-cuts it
    itself and takes the fused branch. Its duplicated UVs equal the
    originals, so it renders as the unsplit mesh; and it equals the port's
    render of the explicitly unified mesh."""
    kw = _render_kw("grid", "port")
    kw["raster_config"] = kw["raster_config"]._replace(backend="auto")
    _, _, pm, pcam = _both("split")
    out = pt.render(pm, pcam, SIZE, SIZE, device="cpu", **kw)
    _hold_render(out, _ref_render("grid"))
    unified = pt.render(pt.unify_mesh_uv(pm), pcam, SIZE, SIZE, device="cpu", **kw)
    for f in ("mask", "attr", "pos", "depth", "normal", "tangent"):
        assert torch.equal(getattr(out, f), getattr(unified, f)), f


def test_vertex_tangents_match_jax():
    verts, faces, uv = jmesh.uv_sphere_mesh(9, 17)
    v, f, u = verts.astype(np.float32), faces.astype(np.int32), uv.astype(np.float32)
    nrm = jmesh.compute_vertex_normals(jnp.asarray(v), jnp.asarray(f))
    want = jmesh.compute_vertex_tangents(jnp.asarray(v), jnp.asarray(f),
                                         jnp.asarray(u), jnp.asarray(f), nrm)
    got = pt.compute_vertex_tangents(_t(v), _t(f).long(), _t(u), _t(f).long(),
                                     _t(_np(nrm)))
    # Sums in another order (XLA's gather-sum vs the corner-list order).
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)
    jm = jmesh.with_normals(wr.TexturedMesh(
        v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(f), v_tex=jnp.asarray(u),
        t_tex_idx=jnp.asarray(f)), compute_tangents=True)
    pm = pt.with_normals(pt.mesh_from_arrays(v, f, v_tex=u, t_tex_idx=f,
                                             device="cpu"), compute_tangents=True)
    np.testing.assert_allclose(_np(pm.v_tang), _np(jm.v_tang), rtol=0, atol=1e-6)


def test_unify_mesh_uv_matches_jax():
    verts, faces, uv, t_tex, _ = _scene("split")
    jm = jmesh.unify_mesh_uv(wr.TexturedMesh(
        v_pos=jnp.asarray(verts), t_pos_idx=jnp.asarray(faces),
        v_tex=jnp.asarray(uv), t_tex_idx=jnp.asarray(t_tex)))
    pm = pt.unify_mesh_uv(pt.mesh_from_arrays(verts, faces, v_tex=uv,
                                              t_tex_idx=t_tex, device="cpu"))
    assert pm.v_pos.shape[0] == verts.shape[0] + 47
    for f in ("v_pos", "t_pos_idx", "v_tex", "t_tex_idx", "stitched_v_pos",
              "stitched_t_pos_idx"):
        np.testing.assert_array_equal(_np(getattr(pm, f)), _np(getattr(jm, f)),
                                      err_msg=f)
    np.testing.assert_allclose(_np(pm.v_nrm), _np(jm.v_nrm), rtol=0, atol=1e-6)
    same = pt.mesh_from_arrays(verts, faces, v_tex=uv[:verts.shape[0]],
                               t_tex_idx=faces, device="cpu")
    assert pt.unify_mesh_uv(same) is same


def test_auto_pack_mode():
    """"auto" picks u8 for a CPU texture of at least 512² texels that is
    k/255 within 1e-6, or for a registered one; else none."""
    q = _t(_checker())
    assert prender._auto_pack_mode(q, True, "linear") == "u8"
    assert prender._auto_pack_mode(q, True, "auto_mip") == "none"
    assert prender._auto_pack_mode(q, False, "linear") == "none"
    assert prender._auto_pack_mode(q[:256], True, "linear") == "none"
    off = q + 3e-6
    assert prender._auto_pack_mode(off.clamp(0, 1), True, "linear") == "none"
    noisy = torch.rand((512, 512, 3), generator=torch.Generator().manual_seed(0))
    assert prender._auto_pack_mode(noisy, True, "linear") == "none"
    pt.register_quantized_texture(noisy)
    assert prender._auto_pack_mode(noisy, True, "linear") == "u8"


def test_caches_hold_weak_references():
    """A registered texture that is dropped frees its entry, and so does a
    seam-cut mesh whose tensors are dropped; an entry is found only for
    the very tensors it was made for."""
    tex = torch.rand(4, 4, 3)
    pt.register_quantized_texture(tex)
    assert pt.is_registered_quantized_texture(tex)
    assert not pt.is_registered_quantized_texture(tex.clone())
    key = id(tex)
    del tex
    gc.collect()
    assert all(key not in k for k in pmesh._QUANT_TEX_CACHE.entries)

    verts, faces, uv, t_tex, _ = _scene("split")
    m = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=t_tex, device="cpu")
    first = pmesh._unify_cached(m)
    assert pmesh._unify_cached(m).t_pos_idx is first.t_pos_idx  # a hit
    n = len(pmesh._UNIFY_CACHE.entries)
    del m
    gc.collect()
    assert len(pmesh._UNIFY_CACHE.entries) == n - 1
