"""Gradients of the PyTorch port against ``jax.grad`` of the JAX package, and
the math helpers (``ops/tensor.py``'s public helpers, ``geometry.py``)
against the JAX package.

Gradients: ``render``'s colour w.r.t. the texture on all three backends
(``tests/test_differentiability.py``'s scene), ``interpolate`` w.r.t. its
attributes, ``antialias`` w.r.t. colour and clip positions, and
``rasterize_diff`` w.r.t. clip positions, each the same loss on the same
inputs in both packages; then the JAX package's own checks of
``test_differentiability.py`` (finite differences, the primal and the
recompute) on the port. Each tolerance is stated at its assert, as a share
of the largest |gradient|. Inputs come from seeds with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu as wr
from worldrenderer_tpu import geometry as jgeo
from worldrenderer_tpu.ops import tensor as jt
from worldrenderer_tpu.ops.antialias import antialias as j_antialias
from worldrenderer_tpu.ops.interpolate import interpolate as j_interpolate
from worldrenderer_tpu.ops.rasterize import RasterizerConfig as JConfig
from worldrenderer_tpu.ops.rasterize import rasterize_diff as j_rasterize_diff
from worldrenderer_tpu.render import render as j_render

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch import geometry as pgeo
from worldrenderer_tpu_torch.ops import tensor as ptn
from worldrenderer_tpu_torch.ops.rasterize import _diff_barycentrics

from test_torch_kernel_designs import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")
BACKENDS = ("xla", "fused_xla", "fused_pallas")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x, **kw):
    return torch.tensor(np.asarray(x), **kw)


def _port_cam(jc):
    return pt.camera_from_arrays(*(_np(getattr(jc, f)) for f in CAM_FIELDS),
                                 device="cpu")


def _close_to_max(ours, ref, share, what):
    """|ours - ref| <= share * max|ref|, elementwise."""
    ours, ref = _np(ours), _np(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0, what
    err = float(np.abs(ours - ref).max())
    assert err <= share * scale, f"{what}: max err {err} of max |g| {scale}"


# ---- render w.r.t. the texture ---------------------------------------------


@pytest.fixture(scope="module")
def tex_scene():
    """test_differentiability.py:26's scene in both packages, its target
    (the port's render, handed to both), and jax.grad of its loss w.r.t.
    the texture on each backend."""
    verts, faces, uv = wr.mesh.uv_sphere_mesh(17, 33)
    tex = np.linspace(0.1, 0.9, 16 * 16 * 3, dtype=np.float32).reshape(16, 16, 3)
    jm = wr.TexturedMesh(
        v_pos=jnp.asarray(verts, jnp.float32),
        t_pos_idx=jnp.asarray(faces, jnp.int32),
        v_tex=jnp.asarray(uv, jnp.float32),
        t_tex_idx=jnp.asarray(faces, jnp.int32), texture=jnp.asarray(tex))
    # normals made eagerly: under jit the reference would cache a traced
    # incidence table on the mesh
    jm = wr.with_normals(jm)
    jc = wr.get_camera(elevation_deg=20.0, distance=3.0, fovy_deg=45.0,
                       num_views=2, near=0.1, far=10.0)
    pm = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                             texture=tex, device="cpu")
    pc = _port_cam(jc)
    target = _np(pt.render(pm, pc, 48, 48, render_attr=True, render_depth=False,
                           render_normal=False, device="cpu").attr)
    grads = {}
    for backend in BACKENDS:
        def loss(t, backend=backend):
            out = j_render(jm, jc, 48, 48, render_attr=True, render_depth=False,
                           render_normal=False, texture_override=t,
                           raster_config=JConfig(backend=backend)).attr
            return jnp.mean((out - target * 0.5) ** 2)
        # jitted (a quarter of the time op by op takes): the contracted
        # FMAs move the reference's gradient by 1.8e-5 of its largest
        grads[backend] = np.asarray(jax.jit(jax.grad(loss))(jm.texture))
    return dict(pm=pm, pc=pc, tex=tex, target=torch.tensor(target), grads=grads)


def _port_tex_loss(scene, tex, backend, scale=0.5):
    # 16x32 tiles: the plain tile passes scan fewer pixels outside the
    # 48x48 views than at the default 32x128 (the output is the same).
    out = pt.render(scene["pm"], scene["pc"], 48, 48, render_attr=True,
                    render_depth=False, render_normal=False,
                    texture_override=tex,
                    raster_config=pt.RasterizerConfig(backend=backend,
                                                      tile_h=16, tile_w=32),
                    device="cpu").attr
    return torch.mean((out - scene["target"] * scale) ** 2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_render_texture_gradient_matches_jax(tex_scene, backend):
    tex = torch.tensor(tex_scene["tex"], requires_grad=True)
    _port_tex_loss(tex_scene, tex, backend).backward()
    g = tex.grad
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    # measured 2.9e-8 of 1.8e-3 (the sums over pixels round in other
    # orders)
    _close_to_max(g, tex_scene["grads"][backend], 1e-4, f"texture grad {backend}")

    # test_differentiability.py:48 on the port: central differences at the
    # largest-gradient texel.
    ga = g.numpy()
    idx = np.unravel_index(np.abs(ga).argmax(), ga.shape)
    eps = 1e-3
    with torch.no_grad():
        tp, tm = tex.detach().clone(), tex.detach().clone()
        tp[idx] += eps
        tm[idx] -= eps
        fd = (float(_port_tex_loss(tex_scene, tp, backend))
              - float(_port_tex_loss(tex_scene, tm, backend))) / (2 * eps)
    np.testing.assert_allclose(ga[idx], fd, rtol=5e-2, atol=1e-5)


def test_texture_fit_converges_on_the_port(tex_scene):
    """test_differentiability.py:75's loop on the port: 20 SGD steps of
    ``loss.backward()`` through the fused path reduce the loss."""
    tex = torch.full_like(torch.from_numpy(tex_scene["tex"]), 0.5,
                          requires_grad=True)
    with torch.no_grad():
        l0 = float(_port_tex_loss(tex_scene, tex, "fused_xla", scale=1.0))
    for _ in range(20):
        loss = _port_tex_loss(tex_scene, tex, "fused_xla", scale=1.0)
        tex.grad = None
        loss.backward()
        with torch.no_grad():
            tex -= 200.0 * tex.grad
    with torch.no_grad():
        l1 = float(_port_tex_loss(tex_scene, tex, "fused_xla", scale=1.0))
    assert l1 < 0.3 * l0, (l0, l1)


# ---- interpolate and antialias ---------------------------------------------


@pytest.fixture(scope="module")
def sphere_rast():
    """The 9x17 UV sphere (its poles hold degenerate triangles) in 2 views
    at 48², the port's rast (equal to the JAX package's op by op) given to
    both packages, and seeded attributes, colours and weights."""
    verts, faces, _ = wr.mesh.uv_sphere_mesh(9, 17)
    jc = wr.get_camera(elevation_deg=25.0, distance=2.8, fovy_deg=45.0,
                       num_views=2, near=0.1, far=10.0)
    pos = np.asarray(wr.get_clip_space_position(jnp.asarray(verts, jnp.float32),
                                                jc.mvp_mtx))
    tri = faces.astype(np.int32)
    rast = _np(pt.rasterize(_t(pos), _t(tri).long(), (48, 48), device="cpu"))
    rng = np.random.default_rng(5)
    return dict(pos=pos, tri=tri, rast=rast,
                attr=rng.random((1, verts.shape[0], 3)).astype(np.float32),
                color=rng.random((2, 48, 48, 3)).astype(np.float32),
                wf=rng.random((2, 48, 48, 3)).astype(np.float32))


def test_interpolate_gradient_matches_jax(sphere_rast):
    s = sphere_rast
    gj = jax.grad(lambda a: jnp.sum(
        j_interpolate(a, jnp.asarray(s["rast"]), jnp.asarray(s["tri"])) * s["wf"]))(
        jnp.asarray(s["attr"]))
    a = torch.tensor(s["attr"], requires_grad=True)
    (pt.interpolate(a, _t(s["rast"]), _t(s["tri"]).long(), device="cpu")
     * _t(s["wf"])).sum().backward()
    # measured 0 of 65.6: the sums over many pixels per vertex may round in
    # other orders
    _close_to_max(a.grad, gj, 1e-6, "interpolate grad")


def test_antialias_gradients_match_jax(sphere_rast):
    """Colour and clip positions. The JAX package's position gradient is NaN
    at the vertices of the degenerate pole triangles (background pixels
    gather triangle 0's planes, and autodiff multiplies their infinite
    inverse area by 0); the port's is finite there and agrees with finite
    differences. Elsewhere the two agree."""
    s = sphere_rast
    tri_j = jnp.asarray(s["tri"])

    def jloss(c, p):
        return jnp.sum(j_antialias(c, jnp.asarray(s["rast"]), p, tri_j) * s["wf"])

    # op by op: jitted, XLA contracts the edge crossings' multiply-adds
    # into FMAs and the colour gradient moves by 2.7e-5
    gc, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(s["color"]),
                                             jnp.asarray(s["pos"]))

    def ploss(c, p):
        return (pt.antialias(c, _t(s["rast"]), p, _t(s["tri"]).long(),
                             device="cpu") * _t(s["wf"])).sum()

    c = torch.tensor(s["color"], requires_grad=True)
    p = torch.tensor(s["pos"], requires_grad=True)
    ploss(c, p).backward()
    # colour: measured 3.0e-8 of 1.5
    _close_to_max(c.grad, gc, 1e-6, "antialias colour grad")
    gp = np.asarray(gp)
    assert torch.isfinite(p.grad).all()
    nan = np.isnan(gp)
    assert nan.any(), "the reference's NaN at degenerate triangles is gone"
    ours = p.grad.numpy()
    # positions: measured 3.9e-5 of 40.3 where the reference is finite
    _close_to_max(np.where(nan, 0.0, ours), np.where(nan, 0.0, gp), 1e-6,
                  "antialias position grad")
    idx = tuple(np.argwhere(nan & (np.abs(ours) > 1.0))[0])
    eps = 1e-3
    with torch.no_grad():
        pp, pm_ = p.detach().clone(), p.detach().clone()
        pp[idx] += eps
        pm_[idx] -= eps
        fd = (float(ploss(c.detach(), pp)) - float(ploss(c.detach(), pm_))) / (2 * eps)
    np.testing.assert_allclose(ours[idx], fd, rtol=5e-2)


# ---- rasterize_diff --------------------------------------------------------


@pytest.fixture(scope="module")
def diff_scene():
    """test_differentiability.py:126's scene and loss, and jax.grad of it."""
    verts, faces, uv = wr.mesh.uv_sphere_mesh(9, 17)
    jc = wr.get_camera(elevation_deg=25.0, distance=2.8, fovy_deg=45.0,
                       num_views=1, near=0.1, far=10.0)
    pos0 = np.asarray(wr.get_clip_space_position(
        jnp.asarray(verts, jnp.float32), jc.mvp_mtx))
    tri = faces.astype(np.int32)
    attr = uv.astype(np.float32)[None]
    wfield = np.asarray(jnp.linspace(0, 1, 48)[None, :, None, None]
                        * jnp.linspace(1, 2, 48)[None, None, :, None])

    def loss(pos):
        rast = j_rasterize_diff(pos, jnp.asarray(tri), (48, 48))
        return jnp.sum(j_interpolate(jnp.asarray(attr), rast,
                                     jnp.asarray(tri)) * wfield) / 100.0

    return dict(pos0=pos0, tri=tri, attr=attr, wfield=wfield,
                grad=np.asarray(jax.grad(loss)(jnp.asarray(pos0))))


def _port_diff_loss(s, pos):
    tri = _t(s["tri"]).long()
    rast = pt.rasterize_diff(pos, tri, (48, 48), device="cpu")
    return (pt.interpolate(_t(s["attr"]), rast, tri, device="cpu")
            * _t(s["wfield"])).sum() / 100.0


def test_rasterize_diff_gradient_matches_jax(diff_scene):
    pos = torch.tensor(diff_scene["pos0"], requires_grad=True)
    _port_diff_loss(diff_scene, pos).backward()
    # measured 3.0e-8 of 0.178
    _close_to_max(pos.grad, diff_scene["grad"], 1e-6, "rasterize_diff grad")


def test_rasterize_diff_gradient_matches_finite_differences(diff_scene):
    """test_differentiability.py:126 on the port: central differences on
    the largest-gradient coordinates, at a step small enough that coverage
    (fixed in the model) rarely flips."""
    pos = torch.tensor(diff_scene["pos0"], requires_grad=True)
    _port_diff_loss(diff_scene, pos).backward()
    g = pos.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    checked = 0
    for k in np.argsort(np.abs(g).reshape(-1))[::-1][:6]:
        idx = np.unravel_index(k, g.shape)
        eps = 1e-4
        with torch.no_grad():
            pp, pm_ = pos.detach().clone(), pos.detach().clone()
            pp[idx] += eps
            pm_[idx] -= eps
            fd = (float(_port_diff_loss(diff_scene, pp))
                  - float(_port_diff_loss(diff_scene, pm_))) / (2 * eps)
        if abs(fd) < 1e-7:
            continue
        np.testing.assert_allclose(g[idx], fd, rtol=8e-2, atol=1e-5)
        checked += 1
        if checked >= 3:
            break
    assert checked >= 2, "could not find stable FD probes"


@pytest.mark.parametrize("mesh_size, backend, atol", [
    ((17, 33), "auto", 2e-4),  # 1,024 triangles: K4's route
    ((33, 65), "auto", 5e-4),  # 4,096: the flat path, K1 in uv mode
    ((33, 65), "xla", 5e-4),  # 4,096: K2 in uv mode
])
def test_rasterize_diff_primal_is_rasterize(mesh_size, backend, atol):
    """test_differentiability.py:98 on the port, at each route: the primal
    bit for bit the port's ``rasterize``, the recompute within ``atol`` of
    the rasterizer's (u, v, z/w) on covered pixels, and no gradient on the
    id channel. Below 4,096 triangles the rasterizer resolves (u, v) from
    the same barycentrics (the reference's 2e-4); on the flat path they are
    interpolated attribute planes (uv mode), held to the attribute
    tolerance between backends of ``tests/test_gbuffer.py:35-65``, 5e-4
    (measured 2.8e-4 at 2 of 5,456 pixels)."""
    verts, faces, _ = pt.uv_sphere_mesh(*mesh_size)
    cam = pt.get_camera(elevation_deg=25.0, distance=2.8, fovy_deg=45.0,
                        num_views=2, near=0.1, far=10.0, device="cpu")
    mesh = pt.mesh_from_arrays(verts, faces, device="cpu")
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    cfg = pt.RasterizerConfig(backend=backend, tile_h=16, tile_w=32)
    a = pt.rasterize(pos, mesh.t_pos_idx, (64, 64), cfg, device="cpu")
    p = pos.clone().requires_grad_(True)
    b = pt.rasterize_diff(p, mesh.t_pos_idx, (64, 64), cfg, device="cpu")
    assert torch.equal(a, b.detach())
    assert (a[..., 3] > 0).float().mean() > 0.2
    tid = a[..., 3].to(torch.int32)
    u, v, z = _diff_barycentrics(pos, mesh.t_pos_idx, tid, 64, 64)
    m = tid > 0
    for got, ch in ((u, 0), (v, 1), (z, 2)):
        np.testing.assert_allclose(_np(got)[_np(m)], _np(a[..., ch])[_np(m)],
                                   atol=atol)
    b[..., 3].sum().backward()
    assert p.grad is not None and not p.grad.any()


def test_rasterize_diff_rejects_range_mode():
    with pytest.raises(ValueError, match="range mode"):
        pt.rasterize_diff(torch.zeros(3, 4), torch.zeros(1, 3, dtype=torch.long),
                          (8, 8), device="cpu")


# ---- ops/tensor.py's public helpers ----------------------------------------


def _rel(ours, ref, rtol=1e-6, atol=1e-7, what=""):
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def test_trunc_exp_forward_and_clamped_gradient():
    x = np.array([0.0, 1.0, 20.0, -3.0], np.float32)
    gj = jax.grad(lambda v: jt.trunc_exp(v).sum())(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = pt.ops.trunc_exp(xt)
    y.sum().backward()
    _rel(y, jt.trunc_exp(jnp.asarray(x)), what="trunc_exp")
    _rel(xt.grad, gj, what="trunc_exp grad")
    np.testing.assert_allclose(_np(xt.grad), np.exp(np.minimum(x, 15.0)),
                               rtol=1e-6)


@pytest.mark.parametrize("name", [
    None, "none", "lin2srgb", "exp", "shifted_exp", "trunc_exp",
    "shifted_trunc_exp", "sigmoid", "tanh", "shifted_softplus",
    "scale_-11_01", "negative", "relu", "softplus", "silu",
])
def test_activation_matches_jax(name):
    x = np.random.default_rng(2).uniform(-3, 3, 64).astype(np.float32)
    x[:4] = [0.0, 0.002, 0.0031308, 0.5]
    _rel(ptn.get_activation(name)(torch.from_numpy(x)),
         jt.get_activation(name)(jnp.asarray(x)), what=str(name))


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="Unknown activation"):
        ptn.get_activation("definitely_not_an_activation")


def test_chunk_batch_tensors_tuples_and_dicts(rng):
    x = rng.random((10, 4)).astype(np.float32)
    xt = torch.from_numpy(x)
    out = ptn.chunk_batch(lambda a: a * 2, 3, xt)
    assert isinstance(out, torch.Tensor)
    _rel(out, jt.chunk_batch(lambda a: a * 2, 3, jnp.asarray(x)))
    out = ptn.chunk_batch(lambda a, k=1.0: {"y": a + k, "z": a - 1}, 4, xt, k=2.0)
    _rel(out["y"], x + 2.0)
    _rel(out["z"], x - 1)
    out = ptn.chunk_batch(lambda a: (a, a * 3), 5, xt)
    assert isinstance(out, tuple)
    _rel(out[1], x * 3)
    assert isinstance(ptn.chunk_batch(lambda a: a + 1, 4, x), np.ndarray)
    assert ptn.chunk_batch(lambda a: None, 4, xt) is None
    _rel(ptn.chunk_batch(lambda a: a * 2, 0, xt), x * 2)


def test_rays_intersect_bbox_matches_jax(rng):
    o = rng.uniform(-3, 3, (5, 7, 3)).astype(np.float32)
    d = rng.normal(size=(5, 7, 3)).astype(np.float32)
    d[0, 0] = [0.0, 0.0, -1.0]
    o[0, 0] = [0.0, 0.0, 5.0]
    for radius in (1.0, rng.uniform(0.5, 1.5, (3, 2)).astype(np.float32)
                   * np.array([-1.0, 1.0], np.float32)):
        ours = ptn.rays_intersect_bbox(_t(o), _t(d), radius if isinstance(
            radius, float) else _t(radius))
        ref = jt.rays_intersect_bbox(jnp.asarray(o), jnp.asarray(d),
                                     radius if isinstance(radius, float)
                                     else jnp.asarray(radius))
        for a, b in zip(ours, ref):
            assert tuple(a.shape) == tuple(b.shape)
            _rel(a, b, rtol=1e-6, atol=1e-5)
    t_near, t_far, valid = ptn.rays_intersect_bbox(_t(o[:1, :1]), _t(d[:1, :1]), 1.0)
    assert bool(valid[0, 0]) and abs(float(t_near[0, 0, 0]) - 4.0) < 0.01
    assert abs(float(t_far[0, 0, 0]) - 6.0) < 0.01


def test_polar_c2w_and_mvp_match_jax():
    elev, azim, dist = 0.4, 2.1, 3.0
    c2w = ptn.polar_to_c2w(elev, azim, dist)
    np.testing.assert_array_equal(c2w, jt.polar_to_c2w(elev, azim, dist))
    assert ptn.c2w_to_polar(torch.from_numpy(c2w)) == jt.c2w_to_polar(c2w)
    e2, a2, d2 = ptn.c2w_to_polar(c2w)
    assert abs(e2 - elev) < 1e-5 and abs(a2 - azim) < 1e-5 and abs(d2 - dist) < 1e-5
    assert ptn.c2w_to_polar(ptn.polar_to_c2w(np.pi / 2 - 1e-7, 0.0, 2.0))[1] == 0.0

    jc = wr.get_camera(elevation_deg=25.0, distance=2.0, fovy_deg=50.0,
                       num_views=3, near=0.1, far=10.0)
    pc = _port_cam(jc)
    mvp = ptn.get_mvp_matrix(pc.c2w, pc.proj_mtx)
    _rel(mvp, jt.get_mvp_matrix(jc.c2w, jc.proj_mtx), atol=1e-6)
    _rel(mvp, pc.mvp_mtx, rtol=0, atol=1e-5)
    _rel(ptn.get_mvp_matrix(pc.c2w[1], pc.proj_mtx[1]), mvp[1], rtol=0, atol=0)


def test_small_helpers_match_jax(rng):
    x = rng.normal(size=(6, 3)).astype(np.float32)
    n = rng.normal(size=(6, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    _rel(ptn.reflect(_t(x), _t(n)), jt.reflect(jnp.asarray(x), jnp.asarray(n)))
    _rel(ptn.scale_tensor(_t(x), (-2, 2), (0, 10)),
         jt.scale_tensor(jnp.asarray(x), (-2, 2), (0, 10)))
    _rel(ptn.scale_tensor(_t(x)), x)
    _rel(ptn.get_plucker_rays(_t(x), _t(n)),
         jt.get_plucker_rays(jnp.asarray(x), jnp.asarray(n)))
    for bs in (-1, 4):
        _rel(ptn.get_intrinsic_from_fov(0.7, 48, 64, bs=bs, device="cpu"),
             jt.get_intrinsic_from_fov(0.7, 48, 64, bs=bs), rtol=0, atol=0)
    p = rng.uniform(0.05, 0.95, (7, 5)).astype(np.float32)
    y = (rng.random((7, 5)) > 0.5).astype(np.float32)
    _rel(ptn.binary_cross_entropy(_t(p), _t(y)),
         jt.binary_cross_entropy(jnp.asarray(p), jnp.asarray(y)))
    sdf = rng.normal(size=(20, 1)).astype(np.float32)
    edges = rng.integers(0, 20, (30, 2))
    _rel(ptn.tet_sdf_diff(_t(sdf), _t(edges)),
         jt.tet_sdf_diff(jnp.asarray(sdf), jnp.asarray(edges)))
    _rel(ptn.tet_sdf_diff(_t(np.abs(sdf)), _t(edges)), 0.0)
    r, a, b = ptn.validate_empty_rays(torch.zeros(0, dtype=torch.int32),
                                      torch.zeros(0), torch.zeros(0))
    assert r.shape == a.shape == b.shape == (1,) and r.dtype == torch.int32
    keep = (torch.arange(3), torch.ones(3), torch.ones(3))
    assert ptn.validate_empty_rays(*keep) == keep
    assert ptn.validate_empty_rays(np.zeros(0), None, None)[0].shape == (1,)
    assert pt.dot is pt.transforms.dot
    _rel(pt.dot(_t(x), _t(n)), wr.dot(jnp.asarray(x), jnp.asarray(n)))


@pytest.mark.parametrize("dim", [-1, 0, 1])
def test_fourier_position_encoding_matches_jax(dim, rng):
    x = rng.normal(size=(4, 3, 2)).astype(np.float32)
    ours = ptn.fourier_position_encoding(_t(x), n_freq=3, dim=dim)
    ref = jt.fourier_position_encoding(jnp.asarray(x), n_freq=3, dim=dim)
    assert tuple(ours.shape) == tuple(ref.shape)
    _rel(ours, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        ptn.fourier_position_encoding(_t(x), n_freq=0, dim=dim)


# ---- geometry.py -----------------------------------------------------------


@pytest.fixture(scope="module")
def cams():
    jc = wr.get_camera(elevation_deg=[10.0, 35.0, -20.0], distance=[2.0, 2.5, 3.0],
                       fovy_deg=40.0, azimuth_deg=[0.0, 123.0, 271.5],
                       near=0.1, far=10.0)
    return jc, _port_cam(jc)


def test_position_maps_match_jax(cams):
    jc, pc = cams
    rng = np.random.default_rng(9)
    depth = rng.uniform(1.0, 3.0, (3, 12, 16, 1)).astype(np.float32)
    mask = (rng.random((3, 12, 16, 1)) > 0.3).astype(np.float32)
    intr = np.asarray(jt.get_intrinsic_from_fov(0.7, 12, 16, bs=3))
    ref = jgeo.get_position_map_from_depth(jnp.asarray(depth), jnp.asarray(mask),
                                           jnp.asarray(intr), jc.c2w)
    ours = pgeo.get_position_map_from_depth(_t(depth), _t(mask), _t(intr), pc.c2w)
    _rel(ours, ref, atol=1e-6)
    scale = np.array([1.5, 2.0, 2.5], np.float32)
    ref = jgeo.get_position_map_from_depth_ortho(
        jnp.asarray(depth), jnp.asarray(mask), jc.c2w, scale)
    ours = pgeo.get_position_map_from_depth_ortho(_t(depth), _t(mask), pc.c2w,
                                                  scale)
    _rel(ours, ref, atol=1e-6)
    ours = pgeo.get_position_map_from_depth_ortho(
        _t(depth), _t(mask), pc.c2w, 2.0, image_wh=(16, 12))
    ref = jgeo.get_position_map_from_depth_ortho(
        jnp.asarray(depth), jnp.asarray(mask), jc.c2w, 2.0, image_wh=(16, 12))
    _rel(ours, ref, atol=1e-6)


def test_rays_and_plucker_embeds_match_jax(cams):
    jc, pc = cams
    for principal, centers in ((None, True), ((7.0, 5.5), False)):
        ref = jgeo.get_ray_directions(12, 16, 14.5, principal, centers)
        ours = pgeo.get_ray_directions(12, 16, 14.5, principal, centers,
                                       device="cpu")
        _rel(ours, ref)
    d = pgeo.get_ray_directions(12, 16, 14.5, device="cpu")
    for a, b in zip(pgeo.get_rays(d, pc.c2w[1]),
                    jgeo.get_rays(jnp.asarray(_np(d)), jc.c2w[1])):
        _rel(a, b, atol=1e-6)
    _rel(pgeo.compute_plucker_embed(pc.c2w[2], 16, 12, 14.5),
         jgeo.compute_plucker_embed(jc.c2w[2], 16, 12, 14.5), atol=1e-6)
    fov = [0.6, 0.7, 0.8]
    ours = pgeo.get_plucker_embeds_from_cameras(pc.c2w, fov, 8)
    assert tuple(ours.shape) == (3, 6, 8, 8)
    _rel(ours, jgeo.get_plucker_embeds_from_cameras(jc.c2w, fov, 8), atol=1e-6)
    ours = pgeo.get_plucker_embeds_from_cameras_ortho(pc.c2w, [1.0] * 3, 8)
    _rel(ours, jgeo.get_plucker_embeds_from_cameras_ortho(jc.c2w, [1.0] * 3, 8),
         atol=1e-6)


def test_opencv_from_blender_matches_jax(cams):
    jc, pc = cams
    m = _np(pc.c2w[1]).copy()
    m[:3, :3] *= 1.7  # a scaled world matrix
    for a, b in zip(pgeo.get_opencv_from_blender(_t(m)),
                    jgeo.get_opencv_from_blender(jnp.asarray(m))):
        _rel(a, b, atol=1e-6)
    ours = pgeo.get_opencv_from_blender(_t(m), fov=0.7, image_size=64)
    ref = jgeo.get_opencv_from_blender(jnp.asarray(m), fov=0.7, image_size=64)
    assert [tuple(a.shape) for a in ours] == [tuple(b.shape) for b in ref]
    for a, b in zip(ours[:2], ref[:2]):
        _rel(a, b, atol=1e-6)
    np.testing.assert_array_equal(_np(ours[2]), np.asarray(ref[2]))
