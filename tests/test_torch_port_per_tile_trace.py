"""The per-tile path against the JAX package run op by op
(``jax.disable_jit()``), traced to the clip transform, at tolerance 0.

On ``tests/test_parallel.py``'s 9 x 17 sphere (153 vertices, 8 views at
64², DEFAULT_CONFIG: the per-tile path) the port's positions and depth
part from the JAX package's. The port's clip positions round apart from
the JAX package's there: XLA's CPU GEMM picks its order by vertex count.
Given the JAX package's clip positions, the port's G-buffer (mask,
triangle ids, z) and its render (positions, depth, normals) are the JAX
package's bits. Beside it, the table of vertex counts at which the port's
clip transform takes XLA's order.

Torch and numpy run on one thread; the reference render is made once.
"""

import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import worldrenderer_tpu as wr

import worldrenderer_tpu_torch as pt

CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")
jg = sys.modules["worldrenderer_tpu.ops.gbuffer"]


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


def _port_cam(jc):
    return pt.camera_from_arrays(*(_np(getattr(jc, f)) for f in CAM_FIELDS),
                                 device="cpu")


@pytest.fixture(scope="module")
def per_tile():
    """``tests/test_parallel.py``'s scene (9 x 17 sphere, 8 views at 64²,
    DEFAULT_CONFIG: the per-tile path) rendered by the JAX package op by op,
    with what its ``rasterize_gbuffer`` was given and returned."""
    verts, faces, uv = wr.mesh.uv_sphere_mesh(9, 17)
    verts, faces = verts.astype(np.float32), faces.astype(np.int32)
    jc = wr.get_camera(elevation_deg=15.0, distance=3.0, fovy_deg=45.0,
                       num_views=8, near=0.1, far=10.0)
    jm = wr.TexturedMesh(v_pos=jnp.asarray(verts), t_pos_idx=jnp.asarray(faces))
    seen = []
    real = jg.rasterize_gbuffer

    def keep(*args, **kw):
        seen.append((args, kw, real(*args, **kw)))
        return seen[-1][2]

    kw = dict(render_attr=False, render_depth=True, render_normal=True)
    with jax.disable_jit(), mock.patch.object(jg, "rasterize_gbuffer", keep):
        ref = wr.render(jm, jc, 64, 64, **kw)
    ((args, gkw, gout),) = seen
    return dict(verts=verts, faces=faces, jc=jc, ref=ref, kw=kw, args=args,
                gkw=gkw, gout=gout)


def test_per_tile_gbuffer_matches_jax_given_its_clip_positions(per_tile):
    """The port's ``rasterize_gbuffer`` on the JAX package's op-by-op clip
    positions: mask, triangle ids and z are its bits."""
    clip, faces, v_attr, hw, cfg = per_tile["args"]
    assert clip.shape == (8, 153, 4)
    gkw = per_tile["gkw"]
    out = pt.rasterize_gbuffer(_t(_np(clip)), _t(_np(faces)), _t(_np(v_attr)), hw,
                               pt.config_from_dict(cfg._asdict()),
                               pos_world=_t(_np(gkw["pos_world"])),
                               mvp=_t(_np(gkw["mvp"])), device="cpu")
    gout = per_tile["gout"]
    assert _np(gout.mask).sum() > 15_000
    for name in ("mask", "tri_id", "z", "attr"):
        _same_bits(getattr(out, name), getattr(gout, name), name)


def test_per_tile_render_matches_jax_given_its_clip_positions(per_tile):
    """The port's ``render`` with its clip transform handing back the JAX
    package's clip positions: positions, depth and normals are its bits.
    Its own clip positions differ from them in the last bit (the order XLA
    takes at 153 vertices), and so does its render."""
    prender = sys.modules["worldrenderer_tpu_torch.render"]
    mesh = pt.mesh_from_arrays(per_tile["verts"], per_tile["faces"], device="cpu")
    cam = _port_cam(per_tile["jc"])
    clip = _t(_np(per_tile["args"][0]))
    ref = per_tile["ref"]
    with mock.patch.object(prender, "get_clip_space_position", return_value=clip):
        ours = pt.render(mesh, cam, 64, 64, device="cpu", **per_tile["kw"])
    for name in ("mask", "pos", "depth", "normal"):
        _same_bits(getattr(ours, name), getattr(ref, name), name)
    own = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    assert int((own != clip).sum()) > 0


def _pairwise_clip(verts, mvp):
    """``(x m0 + y m1) + (z m2 + m3)``, each product rounded."""
    v, m = _t(verts), _t(mvp)[:, None]  # (B, 1, 4 i, 4 j)
    return ((v[:, 0:1] * m[..., 0] + v[:, 1:2] * m[..., 1])
            + (v[:, 2:3] * m[..., 2] + m[..., 3]))


# Which order the JAX package's op-by-op clip transform takes at each vertex
# count: the port's FMA chain, the pairwise sum, or neither.
_CLIP_ORDERS = {128: "fma", 256: "fma", 512: "fma", 561: "fma", 1024: "fma",
                2048: "fma", 4096: "fma", 97: "pairwise", 100: "pairwise",
                129: "pairwise", 200: "pairwise", 300: "pairwise",
                1000: "pairwise", 2081: "pairwise", 153: "neither",
                160: "neither", 2079: "neither", 2080: "neither"}


def test_clip_transform_order_by_vertex_count():
    """The reference side's entry "The clip transform's order": the vertex
    counts at which the port's ``mvp_columns`` FMA chain is the JAX
    package's op-by-op clip transform, and those where XLA's CPU GEMM takes
    another order."""
    rng = np.random.default_rng(11)
    jc = wr.get_camera(elevation_deg=15.0, distance=3.0, fovy_deg=45.0,
                       num_views=8, near=0.1, far=10.0)
    mvp = _np(jc.mvp_mtx)
    found = {}
    for n in sorted(_CLIP_ORDERS):
        verts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        with jax.disable_jit():
            ref = _np(wr.get_clip_space_position(jnp.asarray(verts), jnp.asarray(mvp)))
        fma = _np(pt.get_clip_space_position(_t(verts), _t(mvp)))
        pair = _np(_pairwise_clip(verts, mvp))
        found[n] = ("fma" if (fma == ref).all() else
                    "pairwise" if (pair == ref).all() else "neither")
    assert found == _CLIP_ORDERS
