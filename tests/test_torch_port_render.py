"""The port's slice end to end: ``render(..., device="cpu")`` against the JAX
package's ``render`` at the full headline workload of ``bench.py:434``
(6 views at 512², positions + normals, ``auto_fast_config`` budgets).
Camera, mesh and config are handed over as numpy state.

The JAX render runs op by op (``jax.disable_jit``). Jitted, XLA contracts
the triangle setup's multiply-adds into FMAs, which changes the signed
areas of near-degenerate triangles and with them their z planes beyond
fp32 round-off: the jitted reference differs from its own op-by-op run at
a few mask and triangle-id pixels and in z, as it differs from the port
(``test_torch_port_slice.py`` bounds that run). Op by op, the two
packages evaluate the same fp32 expressions: the mask must be equal, and
positions and normals agree to fp32 round-off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu as wr
from worldrenderer_tpu.ops.rasterize import auto_fast_config as j_auto_fast_config
from worldrenderer_tpu.render import (
    DepthControlNetNormalization,
    SimpleNormalization,
    Zero123PlusPlusNormalization,
)
from worldrenderer_tpu.transforms import get_clip_space_position as j_clip

import worldrenderer_tpu_torch as pt

CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _both(n_views, size):
    """(JAX mesh, JAX camera, port mesh, port camera, JAX fast config with
    exact fp32 dots) for the headline heightfield."""
    verts, faces = wr.mesh.make_grid_mesh(
        72, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y))
    verts, faces = verts.astype(np.float32), faces.astype(np.int32)
    jcam = wr.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                         num_views=n_views, near=0.1, far=10.0)
    pcam = pt.camera_from_arrays(*(_np(getattr(jcam, f)) for f in CAM_FIELDS),
                                 device="cpu")
    jmesh = wr.TexturedMesh(v_pos=jnp.asarray(verts), t_pos_idx=jnp.asarray(faces))
    pmesh = pt.mesh_from_arrays(verts, faces, device="cpu")
    jcfg = j_auto_fast_config(j_clip(jmesh.v_pos, jcam.mvp_mtx), jmesh.t_pos_idx,
                              (size, size))
    pcfg = pt.auto_fast_config(
        pt.get_clip_space_position(pmesh.v_pos, pcam.mvp_mtx), pmesh.t_pos_idx,
        (size, size))
    assert tuple(pcfg) == tuple(jcfg)
    return jmesh, jcam, pmesh, pcam, jcfg._replace(dot_precision="highest")


def _compare(jo, po, fields):
    """Mask equal; every other channel within its tolerance everywhere
    (background included: zeros, the background normal, or the depth
    normalization's background value)."""
    m = _np(jo.mask)
    np.testing.assert_array_equal(_np(po.mask), m)
    assert m.sum() > 0.2 * m.size
    for f, atol in fields:
        np.testing.assert_allclose(_np(getattr(po, f)), _np(getattr(jo, f)),
                                   atol=atol, rtol=0, err_msg=f)


def test_render_headline_matches_jax():
    jmesh, jcam, pmesh, pcam, cfg = _both(6, 512)
    # the budgets bench_headline renders with
    assert (cfg.bin_med, cfg.bin_huge, cfg.max_tris_per_tile,
            cfg.bin_flat_cap_factor) == (0, 16, 1536, 2)
    kw = dict(render_attr=False, render_depth=False, render_normal=True)
    with jax.disable_jit():
        jo = wr.render(jmesh, jcam, 512, 512, raster_config=cfg, **kw)
    po = pt.render(pmesh, pcam, 512, 512, device="cpu",
                   raster_config=pt.config_from_dict(cfg._asdict()), **kw)
    assert po.depth is None and po.attr is None
    _compare(jo, po, (("pos", 1e-5), ("normal", 5e-4)))


@pytest.mark.parametrize("name, args", [
    ("DepthControlNetNormalization", ()),
    ("DepthControlNetNormalization", (0.4, 0.9, 0.2)),
    ("Zero123PlusPlusNormalization", ()),
    ("SimpleNormalization", ()),
    ("SimpleNormalization", (0.3, -0.5, False, 0.7)),
])
def test_depth_normalizations_match_jax(rng, name, args):
    depth = (rng.random((3, 17, 19)) * 4.0 + 1.0).astype(np.float32)
    mask = rng.random((3, 17, 19)) > 0.3
    ref = {c.__name__: c for c in (DepthControlNetNormalization,
                                   SimpleNormalization,
                                   Zero123PlusPlusNormalization)}[name](*args)
    ours = getattr(pt, name)(*args)
    np.testing.assert_allclose(
        _np(ours(torch.from_numpy(depth), torch.from_numpy(mask))),
        _np(ref(jnp.asarray(depth), jnp.asarray(mask))), rtol=1e-6, atol=1e-6)
