"""The PyTorch port's triangle setup and flat binning against the JAX
package, stage by stage on identical inputs.

Both sides get the same clip coordinates (numpy) and the JAX stage
functions run op by op, so integer lists must be equal and planes agree to
fp32 round-off."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu as wr
import worldrenderer_tpu.ops.rasterize  # noqa: F401  (sys.modules below)
from worldrenderer_tpu.mesh import icosphere, make_grid_mesh
from worldrenderer_tpu.transforms import get_clip_space_position as j_clip

import worldrenderer_tpu_torch as pt
import worldrenderer_tpu_torch.ops.rasterize  # noqa: F401  (sys.modules below)

# `worldrenderer_tpu.ops` re-exports a function named like the module.
jr = sys.modules["worldrenderer_tpu.ops.rasterize"]
pr = sys.modules["worldrenderer_tpu_torch.ops.rasterize"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _height(x, y):
    return 0.3 * np.sin(3 * x) * np.cos(3 * y)


def _scene(name):
    """(v4 (B, 4, 3, T) f32 clip corners, faces (T, 3) i32, verts (V, 3),
    H, W) for a named scene."""
    if name == "headline":  # bench.py:434 workload, views 0 and 3
        verts, faces = make_grid_mesh(72, height_fn=_height)
        cam = wr.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                            num_views=6, near=0.1, far=10.0)[[0, 3]]
        hw = (512, 512)
    elif name == "crossing":  # camera inside the grid's extent: w <= 0 corners
        verts, faces = make_grid_mesh(72, height_fn=_height)
        cam = wr.get_camera(elevation_deg=25.0, distance=0.6, fovy_deg=70.0,
                            azimuth_deg=[10.0, 200.0], near=0.05, far=10.0)
        hw = (256, 384)
    elif name == "nan":  # one NaN vertex and one far behind the camera
        verts, faces = make_grid_mesh(72, height_fn=_height)
        verts[100] = np.nan
        verts[2000] = (-40.0, -40.0, -30.0)
        cam = wr.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                            azimuth_deg=[0.0, 90.0], near=0.1, far=10.0)
        hw = (256, 256)
    elif name == "icosphere":  # tests/test_gbuffer.py:18
        verts, faces = icosphere(2)
        cam = wr.get_camera(elevation_deg=20.0, distance=3.0, fovy_deg=45.0,
                            num_views=2, near=0.1, far=10.0)
        hw = (64, 128)
    else:
        raise KeyError(name)
    verts = verts.astype(np.float32)
    faces = faces.astype(np.int32)
    pos = _np(j_clip(jnp.asarray(verts), cam.mvp_mtx))
    t_total = faces.shape[0]
    v4 = pos[:, faces.T.reshape(-1)].transpose(0, 2, 1).reshape(
        pos.shape[0], 4, 3, t_total)
    return np.ascontiguousarray(v4), faces, verts, hw[0], hw[1]


def _setups(v4, faces, w, h, backface_cull=0):
    js = [jr._triangle_setup_t(None, jnp.asarray(faces), w, h,
                               v4=jnp.asarray(v), backface_cull=backface_cull)
          for v in v4]
    ps = pr._triangle_setup_t(torch.from_numpy(v4), w, h, backface_cull)
    return js, ps


@pytest.mark.parametrize("scene", ["headline", "crossing", "nan"])
@pytest.mark.parametrize("backface_cull", [0, -1])
def test_triangle_setup_matches_jax(scene, backface_cull):
    v4, faces, _, h, w = _scene(scene)
    js, ps = _setups(v4, faces, w, h, backface_cull)
    for field in ("valid", "planes12", "inv_w", "inv_area", "bbox4"):
        ref = np.stack([_np(getattr(s, field)) for s in js])
        ours = _np(getattr(ps, field))
        if field == "valid":
            np.testing.assert_array_equal(ours, ref)
        else:  # fp32 round-off; NaN where the reference has NaN
            np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0,
                                       err_msg=field)
    if scene == "crossing":
        w_corner = v4[:, 3]
        assert ((w_corner > 1e-8).any(1) & ~(w_corner > 1e-8).all(1)).any()


_FAST = pt.FAST_TPU_CONFIG._replace(bin_huge=16, bin_med=0)
_BIN_CASES = {
    # name: (scene, config)
    "fast": ("headline", _FAST),
    "no_cull": ("headline", _FAST._replace(bin_cull=False)),
    "medium": ("headline", _FAST._replace(bin_span_tiles_y=1,
                                          bin_span_tiles_x=1, bin_med=64)),
    "two_stage": ("headline", _FAST._replace(bin_small_cap=4096)),
    "crossing": ("crossing", pt.RasterizerConfig(bin_cull=True,
                                                 backface_cull=-1)),
    "nan": ("nan", _FAST._replace(bin_huge=256)),
}


def _bin_args(cfg, w, h):
    args = (w, h, cfg.tile_h, cfg.tile_w, cfg.bin_span_tiles_y,
            cfg.bin_span_tiles_x, cfg.bin_huge, cfg.bin_flat_cap_factor)
    kw = dict(n_med=cfg.bin_med, med_span_y=cfg.bin_med_span_y,
              med_span_x=cfg.bin_med_span_x, cap_abs=cfg.bin_flat_cap_abs,
              small_cap=cfg.bin_small_cap,
              cull_margin=jr._CULL_MARGIN if cfg.bin_cull else 0.0)
    return args, kw


@pytest.mark.parametrize("case", sorted(_BIN_CASES))
def test_bin_flat_matches_jax(case):
    scene, cfg = _BIN_CASES[case]
    v4, faces, _, h, w = _scene(scene)
    js, ps = _setups(v4, faces, w, h, cfg.backface_cull)
    args, kw = _bin_args(cfg, w, h)
    ref = [jr._bin_flat(s, *args, **kw) for s in js]
    ours = pr._bin_flat(ps, *args, **kw)
    for i, name in enumerate(("s_tri", "s_tile", "starts", "counts")):
        np.testing.assert_array_equal(
            _np(ours[i]), np.stack([_np(r[i]) for r in ref]), err_msg=name)
    live = _np(ours[3]).sum()
    assert live > 0


def test_topk_small_matches_jax(rng):
    prio = rng.integers(0, 5, size=(3, 200)).astype(np.int32)
    ref = [jr._topk_small(jnp.asarray(p), 16) for p in prio]
    vals, idx = pr._topk_small(torch.from_numpy(prio), 16)
    np.testing.assert_array_equal(_np(vals), np.stack([_np(r[0]) for r in ref]))
    np.testing.assert_array_equal(_np(idx), np.stack([_np(r[1]) for r in ref]))
    # the tie rule it rests on: argmax returns the first maximum
    assert int(torch.argmax(torch.tensor([1, 7, 3, 7, 7]))) == 1


@pytest.mark.parametrize("backface_cull", [0, -1])
def test_binning_stats_and_auto_fast_config_match_jax(backface_cull):
    verts, faces = make_grid_mesh(72, height_fn=_height)
    cam = wr.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                        num_views=6, near=0.1, far=10.0)
    pos = j_clip(jnp.asarray(verts, jnp.float32), cam.mvp_mtx)
    tri = jnp.asarray(faces, jnp.int32)
    ref_cfg = jr.auto_fast_config(pos, tri, (512, 512),
                                  backface_cull=backface_cull)
    tpos, ttri = torch.from_numpy(_np(pos)), torch.from_numpy(faces)
    cfg = pr.auto_fast_config(tpos, ttri, (512, 512),
                              backface_cull=backface_cull)
    assert tuple(cfg) == tuple(ref_cfg)
    assert pr.binning_stats(tpos, ttri, (512, 512), cfg) == jr.binning_stats(
        pos, tri, (512, 512), ref_cfg)
    tight = cfg._replace(bin_huge=1, bin_flat_cap_factor=1)
    assert pr.binning_stats(tpos, ttri, (512, 512), tight) == jr.binning_stats(
        pos, tri, (512, 512), jr.RasterizerConfig(*tight))
