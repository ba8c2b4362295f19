"""The port's slice against the JAX package as users run it, and a small
render with depth.

``rasterize_gbuffer`` at the headline workload against the JITTED JAX
function: XLA fuses the jitted triangle setup and contracts multiply-adds
into FMAs, so pixel centres within an ulp of an edge, or of a z tie, can
change hands (the same pixels move between the JAX package's own jitted
and op-by-op runs). The flip budget — at most 1e-4 of foreground pixels
differ in mask or triangle id, the spirit of ``utils/validate.py``'s id
budget — is the only tolerance here; ``test_torch_port_render.py`` holds
the values to fp32 round-off against the op-by-op reference."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import worldrenderer_tpu as wr
from worldrenderer_tpu.mesh import compute_vertex_normals, make_grid_mesh
from worldrenderer_tpu.ops.gbuffer import rasterize_gbuffer as j_rasterize_gbuffer
from worldrenderer_tpu.ops.rasterize import auto_fast_config as j_auto_fast_config
from worldrenderer_tpu.transforms import get_clip_space_position as j_clip

import worldrenderer_tpu_torch as pt

CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _heightfield():
    verts, faces = make_grid_mesh(
        72, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y))
    return verts.astype(np.float32), faces.astype(np.int32)


def test_rasterize_gbuffer_headline_within_flip_budget_of_jitted_jax():
    verts, faces = _heightfield()
    cam = wr.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                        num_views=6, near=0.1, far=10.0)
    pos = j_clip(jnp.asarray(verts), cam.mvp_mtx)
    tri = jnp.asarray(faces)
    cfg = j_auto_fast_config(pos, tri, (512, 512))._replace(
        dot_precision="highest")
    nrm = _np(compute_vertex_normals(jnp.asarray(verts), tri))
    mvp = _np(cam.mvp_mtx)
    ref = j_rasterize_gbuffer(pos, tri, jnp.asarray(nrm), (512, 512), cfg,
                              pos_world=jnp.asarray(verts),
                              mvp=jnp.asarray(mvp))
    out = pt.rasterize_gbuffer(
        torch.from_numpy(_np(pos)), torch.from_numpy(faces),
        torch.from_numpy(nrm), (512, 512), pt.config_from_dict(cfg._asdict()),
        pos_world=torch.from_numpy(verts), mvp=torch.from_numpy(mvp),
        device="cpu")
    fg = int(_np(ref.mask).sum())
    assert fg > 500_000
    budget = 1e-4 * fg
    assert (_np(out.mask) != _np(ref.mask)).sum() <= budget
    assert (_np(out.tri_id) != _np(ref.tri_id)).sum() <= budget
    assert out.tri_id.dtype == torch.int32 and out.attr.shape == (6, 512, 512, 3)


def test_render_small_with_depth_matches_jax():
    """2 views at 128², depth with the default normalization, op by op."""
    verts, faces = _heightfield()
    jcam = wr.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                         num_views=2, near=0.1, far=10.0)
    pcam = pt.camera_from_arrays(*(_np(getattr(jcam, f)) for f in CAM_FIELDS),
                                 device="cpu")
    jmesh = wr.TexturedMesh(v_pos=jnp.asarray(verts), t_pos_idx=jnp.asarray(faces))
    cfg = j_auto_fast_config(j_clip(jmesh.v_pos, jcam.mvp_mtx), jmesh.t_pos_idx,
                             (128, 128))._replace(dot_precision="highest")
    kw = dict(render_attr=False, render_depth=True, render_normal=True)
    with jax.disable_jit():
        jo = wr.render(jmesh, jcam, 128, 128, raster_config=cfg, **kw)
    po = pt.render(pt.mesh_from_arrays(verts, faces, device="cpu"), pcam, 128,
                   128, raster_config=pt.config_from_dict(cfg._asdict()),
                   device="cpu", **kw)
    m = _np(jo.mask)
    np.testing.assert_array_equal(_np(po.mask), m)
    assert m.sum() > 0.2 * m.size
    for f, atol in (("pos", 1e-5), ("depth", 1e-5), ("normal", 2e-6)):  # 7.7e-7 read
        np.testing.assert_allclose(_np(getattr(po, f)), _np(getattr(jo, f)),
                                   atol=atol, rtol=0, err_msg=f)
