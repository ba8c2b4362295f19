"""The port's classic API end to end against the JAX package:
``rasterize``, ``rasterize_db`` and ``interpolate`` on the per-tile path
(kernel K4) and on the flat path (kernel K1 in uv mode), the bake's
UV-atlas pass, and ``rasterize_gbuffer`` with a foreign attribute
topology.

Both packages get the same numpy inputs; the reference runs op by op with
its kernels jitted (the ``reference`` fixture of
``test_torch_port_tiles.py``, which explains why). Per-tile results are
equal bit for bit. On the flat path the port's K1 rounds its planes as
separate products and sums where the reference's kernels round as their
plane dot, so pixel centres on an edge may change hands: ids and masks are
held to a flip budget of 1e-4 of the foreground pixels, z within 1e-5 and
(u, v), attributes and derivatives within 5e-4 (the tolerances
``tests/test_gbuffer.py`` holds the JAX backends to) where the ids
agree."""

import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu as wr
import worldrenderer_tpu.ops.gbuffer  # noqa: F401  (sys.modules below)
import worldrenderer_tpu.ops.rasterize  # noqa: F401
from worldrenderer_tpu.mesh import uv_sphere_mesh
from worldrenderer_tpu.ops.interpolate import interpolate as j_interpolate
from worldrenderer_tpu.transforms import get_clip_space_position as j_clip

import worldrenderer_tpu_torch as pt

from test_torch_port_tiles import reference, scene  # noqa: F401  (a fixture)

jr = sys.modules["worldrenderer_tpu.ops.rasterize"]
jg = sys.modules["worldrenderer_tpu.ops.gbuffer"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _headline(size):
    """The slice-1 headline heightfield (10,082 triangles, the flat path),
    views 0 and 3, at ``size``²."""
    from worldrenderer_tpu.mesh import make_grid_mesh

    verts, faces = make_grid_mesh(
        72, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y))
    cam = wr.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                        num_views=6, near=0.1, far=10.0)[[0, 3]]
    verts = verts.astype(np.float32)
    return (_np(j_clip(jnp.asarray(verts), cam.mvp_mtx)),
            faces.astype(np.int32), verts, size, size)


def _inputs(name):
    return _headline(128) if name == "headline" else scene(name)


_PALLAS = jr.RasterizerConfig(backend="pallas")


@functools.lru_cache(maxsize=None)
def _ref_rasterize(name):
    """The reference's ``rasterize`` of a scene (call it under the
    ``reference`` fixture); shared by the rasterize and rasterize_db tests."""
    pos, faces, _, h, w = _inputs(name)
    return _np(jr.rasterize(jnp.asarray(pos), jnp.asarray(faces), (h, w), _PALLAS))


@functools.lru_cache(maxsize=None)
def _port_rasterize_db(name):
    """The port's ``rasterize_db`` of a scene on the CPU; shared by the
    rasterize_db and interpolate tests (its plain K4 is the costly part)."""
    pos, faces, _, h, w = _inputs(name)
    return pt.rasterize_db(_t(pos), _t(faces), (h, w),
                           pt.config_from_dict(_PALLAS._asdict()), device="cpu")


def _within_flip_budget(ours, ref):
    """At most 1e-4 of the foreground pixels (at least one) differ."""
    fg = int((ref > 0).sum())
    assert (ours != ref).sum() <= max(1, 1e-4 * fg)
    return ours == ref


def _check_rast(ours, ref, exact):
    """Per-tile rasts bit for bit. Flat-path rasts come from K1, whose
    planes round as separate products and sums, where the reference's
    flat rows round as its plane dot: ids within the flip budget, z, u and
    v within the tolerances where the ids agree."""
    ours, ref = _np(ours), _np(ref)
    if exact:
        np.testing.assert_array_equal(ours, ref)
    same = _within_flip_budget(ours[..., 3], ref[..., 3])
    fg = (ref[..., 3] > 0) & same
    np.testing.assert_allclose(ours[..., 2][fg], ref[..., 2][fg], atol=1e-5)
    np.testing.assert_allclose(ours[..., :2][same], ref[..., :2][same], atol=5e-4)
    assert fg.sum() > 1000
    return same


@pytest.mark.parametrize("name", ["icosphere", "headline"])
def test_rasterize_matches_jax(reference, name):
    """Per-tile (K4) bit for bit against ``backend="pallas"``; the flat
    path (K1 in uv mode) against the reference's DMA kernel."""
    pos, faces, _, h, w = _inputs(name)
    ours = pt.rasterize(_t(pos), _t(faces), (h, w),
                        pt.config_from_dict(_PALLAS._asdict()), device="cpu")
    assert ours.shape == (2, h, w, 4) and ours.dtype == torch.float32
    _check_rast(ours, _ref_rasterize(name), exact=name != "headline")


@pytest.mark.parametrize("name", ["icosphere", "headline"])
def test_rasterize_db_matches_jax(reference, name):
    """rast and rast_db. At the flat path the reference's ``rasterize_db``
    takes another route than its ``rasterize`` (per view, the classic
    setup's einsum-rounded z planes and K2 over flat rows), and its rast
    differs from its own ``rasterize`` by up to 1.4e-4 in z on this scene's
    steep triangles; the port's ``rasterize_db`` returns its ``rasterize``
    (K1 in uv mode), so there the rast is held against the reference's
    ``rasterize`` and the derivatives where the ids agree."""
    pos, faces, _, h, w = _inputs(name)
    ref, ref_db = jr.rasterize_db(jnp.asarray(pos), jnp.asarray(faces), (h, w),
                                  _PALLAS)
    rast, db = _port_rasterize_db(name)
    if name == "headline":
        ref = _ref_rasterize(name)
    same = _check_rast(rast, ref, exact=name != "headline")
    np.testing.assert_allclose(_np(db)[same], _np(ref_db)[same], atol=5e-4)
    if name != "headline":
        np.testing.assert_array_equal(_np(db), _np(ref_db))


@pytest.mark.parametrize("diff", [None, "all", [2, 0]])
def test_interpolate_matches_jax(diff):
    """Attributes and their image-space derivatives from identical rast /
    rast_db images, bit for bit."""
    _, faces, verts, _, _ = scene("icosphere")
    rast, db = _port_rasterize_db("icosphere")
    attr = np.concatenate([verts, verts[:, :1] ** 2], axis=1)[None]
    ref = j_interpolate(jnp.asarray(attr), jnp.asarray(_np(rast)),
                        jnp.asarray(faces), rast_db=jnp.asarray(_np(db)),
                        diff_attrs=diff)
    ours = pt.interpolate(_t(attr), rast, _t(faces), rast_db=db,
                          diff_attrs=diff, device="cpu")
    if diff is None:
        ref, ours = (ref,), (ours,)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(_np(o), _np(r))
    if diff is not None:
        assert ours[1].shape[-1] == 2 * (4 if diff == "all" else len(diff))
    with pytest.raises(ValueError):
        pt.interpolate(_t(attr), rast, _t(faces), diff_attrs="all", device="cpu")


def _uv_clip4(uv):
    c = uv.astype(np.float32) * 2.0 - 1.0
    return np.concatenate([c, np.zeros_like(c[:, :1]), np.ones_like(c[:, :1])],
                          axis=1)[None]


def test_uv_atlas_pass_matches_jax(reference):
    """Workload 2 at 128² (the bake's ``baking/uv.py:99-103`` below the
    flat path): ``rasterize`` of the UV layout, then ``interpolate`` of the
    world positions over the position topology."""
    verts, faces, uv = uv_sphere_mesh(32, 65)
    verts, faces = verts.astype(np.float32), faces.astype(np.int32)
    clip4 = _uv_clip4(uv)
    ref = jr.rasterize(jnp.asarray(clip4), jnp.asarray(faces), (128, 128))
    ref_pos = j_interpolate(jnp.asarray(verts)[None], ref, jnp.asarray(faces))
    rast = pt.rasterize(_t(clip4), _t(faces), (128, 128), device="cpu")
    pos = pt.interpolate(_t(verts)[None], rast, _t(faces), device="cpu")
    np.testing.assert_array_equal(_np(rast), _np(ref))
    np.testing.assert_array_equal(_np(pos), _np(ref_pos))
    assert (_np(ref[..., 3]) > 0).mean() > 0.9


@pytest.mark.parametrize("name", ["sphere", "headline"])
def test_rasterize_gbuffer_tri_attr_matches_jax(reference, name):
    """A foreign attribute topology (``tri_attr``), as ``uv_precompute``
    interpolates world positions while rasterizing the UV atlas: the
    per-tile path bit for bit; the flat path's ids within the flip budget
    (the grid's UV edges run through pixel centres, where K1 and the
    reference's plane dot may round to opposite signs) and its attributes
    within 5e-4 where the ids agree."""
    if name == "sphere":
        verts, faces, uv = uv_sphere_mesh(32, 65)
    else:
        _, faces, verts, _, _ = _headline(128)
        uv = (verts[:, :2] + 1.0) * 0.5
    verts, faces = verts.astype(np.float32), faces.astype(np.int32)
    clip4 = _uv_clip4(uv)
    shift = np.roll(faces, 1, axis=1)  # another corner order, same triangles
    cfg = jr.RasterizerConfig(backend="fused_pallas")
    ref = jg.rasterize_gbuffer(jnp.asarray(clip4), jnp.asarray(shift),
                               jnp.asarray(verts), (256, 256), cfg,
                               tri_attr=jnp.asarray(faces))
    out = pt.rasterize_gbuffer(_t(clip4), _t(shift), _t(verts), (256, 256),
                               pt.config_from_dict(cfg._asdict()),
                               tri_attr=_t(faces), device="cpu")
    m = _np(ref.mask)
    _within_flip_budget(_np(out.mask), m)
    same = _within_flip_budget(_np(out.tri_id), _np(ref.tri_id))
    np.testing.assert_allclose(_np(out.attr)[same], _np(ref.attr)[same],
                               atol=5e-4)
    if name == "sphere":
        np.testing.assert_array_equal(_np(out.mask), m)
        np.testing.assert_array_equal(_np(out.tri_id), _np(ref.tri_id))
        np.testing.assert_array_equal(_np(out.attr), _np(ref.attr))
    assert m.mean() > 0.5
