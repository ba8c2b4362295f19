"""The port's rounding contract for normals against the JAX package run op
by op (``jax.disable_jit()``), at tolerance 0.

The contract: every fp32 value the port computes has the bits of the JAX
package's op-by-op run, except where XLA picks an order by shape (the clip
transform's GEMM) and XLA's transcendentals (``sin``, ``cos``). Here:

- the primitives: ``transforms.cross`` against ``jnp.cross`` and
  ``camera.normalize`` / ``transforms.norm`` against ``normalize`` /
  ``jnp.linalg.norm`` on 100,000 seeded random rows, at last dims 2, 3 and
  4, along axis 0 and on stacked 3 x 3 bases;
- ``compute_vertex_normals`` and ``compute_vertex_tangents`` on two UV
  spheres, a random mesh and fans whose centre takes 40 and 100 faces (the
  JAX package sums a vertex's rows from an incidence table of width at
  most 64, in windows of 32 above 32 wide, and by a scatter-add above 64);
- every site that normalizes or crosses: ``render``'s normal and tangent
  channels (a UV sphere of 561 vertices, 8 views at 128²), ``get_c2w``'s
  basis (given the JAX package's own camera positions: the positions
  themselves differ where XLA's ``cos`` and ``sin`` round apart from
  torch's), the ray and Plücker helpers, the bake's view-normal cosine and
  the smart painter's camera-space normals (both given the same rendered
  normals), the warp's edge lengths and the matting's distances;
Where the port's clip positions round apart from the JAX package's, the
per-tile path is traced in ``tests/test_torch_port_per_tile_trace.py``.
Torch and numpy run on one thread.
"""

from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import worldrenderer_tpu as wr
from worldrenderer_tpu import camera as jcamera
from worldrenderer_tpu import geometry as jgeo
from worldrenderer_tpu import mesh as jmesh
from worldrenderer_tpu.baking import seg as jseg
from worldrenderer_tpu.baking import smart_paint as jsp
from worldrenderer_tpu.baking import uv as juv
from worldrenderer_tpu.baking import warp as jwarp
from worldrenderer_tpu.ops import tensor as jt

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch import camera as pcamera
from worldrenderer_tpu_torch import geometry as pgeo
from worldrenderer_tpu_torch import mesh as pmesh
from worldrenderer_tpu_torch import transforms as ptf
from worldrenderer_tpu_torch.baking import seg as pseg
from worldrenderer_tpu_torch.baking import smart_paint as psp
from worldrenderer_tpu_torch.baking import uv as puv
from worldrenderer_tpu_torch.baking import warp as pwarp
from worldrenderer_tpu_torch.ops import tensor as ptn

CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")
ROWS = 100_000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_bits(ours, ref, what=""):
    a, b = _np(ours), _np(ref)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), (what, int((a != b).sum()), a.size)


def _rows(seed, shape):
    """Seeded fp32 rows spread over six decades, with some rows zero and
    some of norm below 1e-12 (the eps path of normalize). No product of two
    entries is subnormal: XLA's CPU flushes subnormals to zero and the port
    keeps them (queue 3 of ROADMAP.md)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[:7] = 0.0
    x.reshape(-1, shape[-1])[7:14] = rng.uniform(
        -1e-13, 1e-13, (7, shape[-1])).astype(np.float32)
    return x


def _port_cam(jc):
    return pt.camera_from_arrays(*(_np(getattr(jc, f)) for f in CAM_FIELDS),
                                 device="cpu")


# ---- the primitives -----------------------------------------------------------


@pytest.mark.parametrize("case", ["rows", "axis0", "broadcast"])
def test_cross_matches_jax(case):
    a, b = _rows(1, (ROWS, 3)), _rows(2, (ROWS, 3))
    if case == "axis0":
        a, b = a.T.copy(), b.T.copy()
    if case == "broadcast":  # the normal rebake's fixed geometry tangents
        b = b[:1]
    dim = 0 if case == "axis0" else -1
    with jax.disable_jit():
        ref = jnp.cross(jnp.asarray(a), jnp.asarray(b), axis=dim)
    _same_bits(ptf.cross(_t(a), _t(b), dim=dim), ref)


@pytest.mark.parametrize("shape, axis", [
    ((ROWS, 2), -1), ((ROWS, 3), -1), ((ROWS, 4), -1), ((3, ROWS), 0),
    ((ROWS // 3, 3, 3), -1),
])
def test_normalize_and_norm_match_jax(shape, axis):
    x = _rows(3, shape[::-1] if axis == 0 else shape)
    if axis == 0:
        x = x.T.copy()
    with jax.disable_jit():
        ref = jcamera.normalize(jnp.asarray(x), axis=axis)
        ref_norm = jnp.linalg.norm(jnp.asarray(x), axis=axis)
    _same_bits(pt.normalize(_t(x), axis=axis), ref, "normalize")
    _same_bits(ptf.norm(_t(x), dim=axis), ref_norm, "norm")
    _same_bits(ptf.norm(_t(x), dim=axis, keepdim=True),
               np.expand_dims(_np(ref_norm), axis), "norm keepdim")


def test_warp_and_matting_norms_match_jax():
    """``baking/warp.py``'s edge lengths (the grid at rest and moved) and
    ``baking/seg.py``'s distance to the background, then the matte."""
    verts, _faces, edges, _mov = pwarp.construct_grid_mesh(10)
    np.testing.assert_array_equal(edges, jwarp.construct_grid_mesh(10)[2])
    rng = np.random.default_rng(4)
    v = (verts[:, :2] + rng.normal(0, 0.03, (4,) + verts[:, :2].shape)).astype(np.float32)
    v[0] = verts[:, :2]
    d = v[..., edges[:, 0], :] - v[..., edges[:, 1], :]
    with jax.disable_jit():
        ref = jnp.linalg.norm(jnp.asarray(v)[..., edges[:, 0], :]
                              - jnp.asarray(v)[..., edges[:, 1], :], axis=-1)
    _same_bits(ptf.norm(_t(d)), ref, "warp edges")

    images = rng.random((3, 40, 48, 4)).astype(np.float32)
    bg = np.float32(0.5)
    with jax.disable_jit():
        ref = jnp.linalg.norm(jnp.asarray(images)[..., :3] - bg, axis=-1)
        matte = jseg.ThresholdMatting(threshold=0.3)(images)
    _same_bits(ptf.norm(_t(images)[..., :3] - bg), ref, "matting distance")
    _same_bits(pseg.ThresholdMatting(threshold=0.3, device="cpu")(images), matte,
               "matte")


# ---- vertex normals and tangents -----------------------------------------------


def _fan(k):
    """A cone's fan: vertex 0 in k faces."""
    ang = np.linspace(0, 2 * np.pi, k, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), 0.1 * np.sin(3 * ang)], axis=1)
    verts = np.concatenate([[[0.0, 0.0, 0.3]], rim])
    faces = np.stack([np.zeros(k, int), 1 + np.arange(k), 1 + (np.arange(k) + 1) % k],
                     axis=1)
    uv = np.concatenate([[[0.5, 0.5]], 0.5 + 0.5 * rim[:, :2]])
    return verts, faces, uv


def _mesh(name):
    if name == "sphere_9x17":
        return wr.mesh.uv_sphere_mesh(9, 17)
    if name == "sphere_65x129":
        return wr.mesh.uv_sphere_mesh(65, 129)
    if name == "random_500":  # largest vertex degree 37
        rng = np.random.default_rng(3)
        return (rng.standard_normal((500, 3)), rng.integers(0, 500, (3000, 3)),
                rng.random((500, 2)))
    return _fan(int(name.split("_")[1]))


@pytest.mark.parametrize("name", ["sphere_9x17", "sphere_65x129", "random_500",
                                  "fan_40", "fan_100"])
def test_vertex_normals_and_tangents_match_jax(name):
    verts, faces, uv = _mesh(name)
    verts, faces, uv = (verts.astype(np.float32), faces.astype(np.int32),
                        uv.astype(np.float32))
    with jax.disable_jit():
        ref = jmesh.compute_vertex_normals(jnp.asarray(verts), jnp.asarray(faces))
        ref_t = jmesh.compute_vertex_tangents(
            jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(uv),
            jnp.asarray(faces), ref)
    f = _t(faces).long()
    ours = pt.compute_vertex_normals(_t(verts), f)
    _same_bits(ours, ref, "normals")
    _same_bits(pmesh.compute_vertex_tangents(_t(verts), f, _t(uv), f, ours), ref_t,
               "tangents")


# ---- render's normal and tangent channels ---------------------------------------


def test_render_normals_and_tangents_match_jax():
    """A UV sphere of 561 vertices (where the clip transform takes XLA's
    order), 8 views at 128²: every channel bit for bit."""
    verts, faces, uv = (a.astype(t) for a, t in zip(
        wr.mesh.uv_sphere_mesh(17, 33), (np.float32, np.int32, np.float32)))
    jc = wr.get_camera(elevation_deg=20.0, distance=2.7, fovy_deg=40.0,
                       num_views=8, near=0.1, far=10.0)
    kw = dict(render_attr=False, render_depth=True, render_normal=True,
              render_tangent=True)
    jm = wr.TexturedMesh(v_pos=jnp.asarray(verts), t_pos_idx=jnp.asarray(faces),
                         v_tex=jnp.asarray(uv), t_tex_idx=jnp.asarray(faces))
    with jax.disable_jit():
        ref = wr.render(jm, jc, 128, 128, **kw)
    ours = pt.render(pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                                         device="cpu"),
                     _port_cam(jc), 128, 128, device="cpu", **kw)
    assert _np(ref.mask).mean() > 0.5
    for name in ("mask", "pos", "depth", "normal", "tangent"):
        _same_bits(getattr(ours, name), getattr(ref, name), name)


# ---- cameras, rays and Plücker embeddings ------------------------------------


def test_c2w_basis_matches_jax_on_its_camera_positions():
    """200 seeded orbit cameras. Given the JAX package's camera positions,
    the port's look-at basis is its basis; the whole matrix differs only in
    views whose positions differ (XLA's ``cos`` and ``sin``)."""
    rng = np.random.default_rng(5)
    elev, azim, dist = (rng.uniform(lo, hi, 200).astype(np.float32)
                        for lo, hi in ((-80, 80), (0, 360), (1, 4)))
    with jax.disable_jit():
        ref = _np(jcamera.get_c2w(elev, dist, azim))
    _same_bits(pcamera._look_at_origin(_t(ref[:, :3, 3])), ref[:, :3, :3], "basis")
    ours = _np(pt.get_c2w(elev, dist, azim, device="cpu"))
    same_pos = (ours[:, :3, 3] == ref[:, :3, 3]).all(axis=1)
    assert same_pos.sum() > 150
    _same_bits(ours[same_pos], ref[same_pos], "c2w")


def test_ray_and_plucker_helpers_match_jax():
    """``ops/tensor.get_plucker_rays`` on seeded rows; ``get_ray_directions``
    with and without a principal point and pixel centres;
    ``compute_plucker_embed`` given the JAX package's rays (``get_rays``'
    product ``directions @ R.T`` rounds in an order XLA's CPU picks by
    shape, neither the port's FMA chain nor the sum in index order) and
    the orthographic embeddings (their ``normalize(axis=0)``), on the JAX
    package's own orbit matrices."""
    o, d = _rows(6, (ROWS, 3)), _rows(7, (ROWS, 3))
    with jax.disable_jit():
        ref = jt.get_plucker_rays(jnp.asarray(o), jnp.asarray(d))
    _same_bits(ptn.get_plucker_rays(_t(o), _t(d)), ref, "plucker rays")
    with jax.disable_jit():
        c2w = _np(jcamera.get_c2w([10.0, 35.0, -20.0], [2.0, 2.5, 3.0],
                                  [0.0, 123.0, 271.5]))
        for principal, centers in ((None, True), ((30.0, 21.5), False)):
            ref = jgeo.get_ray_directions(48, 64, 50.5, principal, centers)
            ours = pgeo.get_ray_directions(48, 64, 50.5, principal, centers,
                                           device="cpu")
            _same_bits(ours, ref, "ray directions")
        rays = jgeo.get_rays(jgeo.get_ray_directions(48, 64, 50.5),
                             jnp.asarray(c2w[1]))
        ref = jgeo.compute_plucker_embed(jnp.asarray(c2w[1]), 64, 48, 50.5)
    # The rays themselves are a 3x3 product whose order XLA picks by shape.
    with mock.patch.object(pgeo, "get_rays",
                           return_value=tuple(_t(_np(r)) for r in rays)):
        ours = pgeo.compute_plucker_embed(_t(c2w[1]), 64, 48, 50.5)
    _same_bits(ours, ref, "plucker embed")
    with jax.disable_jit():
        ref = jgeo.get_plucker_embeds_from_cameras_ortho(c2w, [1.0] * 3, 8)
        _same_bits(pgeo.get_plucker_embeds_from_cameras_ortho(_t(c2w), [1.0] * 3, 8),
                   ref, "ortho embeds")


# ---- the bake's and the smart painter's camera-space normals ----------------------


def _given_render(seed, n_views, size, as_array):
    """What a render would hand the sites: seeded normals (unit length to
    fp32 round-off, as a render's are), a mask, positions and depth."""
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((n_views, size, size, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mask = rng.random((n_views, size, size)) > 0.3
    pos = rng.random((n_views, size, size, 3)).astype(np.float32)
    depth = rng.random((n_views, size, size, 1)).astype(np.float32)
    return SimpleNamespace(normal=as_array(nrm), mask=as_array(mask),
                           pos=as_array(pos), depth=as_array(depth), attr=None)


def test_bake_view_cosine_and_painter_normals_match_jax():
    """``baking/uv.py uv_view_geometry``'s camera-space cosine and
    ``baking/smart_paint.py _view_aoi_cos``, each given the same rendered
    normals and cameras as their JAX counterparts."""
    jc = wr.get_camera(elevation_deg=[10.0, 35.0, -20.0, 60.0],
                       distance=[2.0, 2.5, 3.0, 2.2], fovy_deg=40.0,
                       azimuth_deg=[0.0, 123.0, 271.5, 200.0], near=0.1, far=10.0)
    pc = _port_cam(jc)
    verts, faces, _ = wr.mesh.uv_sphere_mesh(5, 9)
    jm = wr.TexturedMesh(v_pos=jnp.asarray(verts, jnp.float32),
                         t_pos_idx=jnp.asarray(faces, jnp.int32))
    pm = pt.mesh_from_arrays(verts, faces, device="cpu")
    jout, pout = (_given_render(8, 4, 96, f) for f in (jnp.asarray, _t))
    with jax.disable_jit(), mock.patch.object(juv, "render", return_value=jout):
        ref = juv.uv_view_geometry(jm, jc, 96, 96)
    with mock.patch.object(puv, "render", return_value=pout):
        ours = puv.uv_view_geometry(pm, pc, 96, 96, device="cpu")
    _same_bits(ours.view_aoi_cos, ref.view_aoi_cos, "bake cosine")
    with jax.disable_jit():
        ref = jsp._view_aoi_cos(jout, jc)
    _same_bits(psp._view_aoi_cos(pout, pc), ref, "painter cosine")
