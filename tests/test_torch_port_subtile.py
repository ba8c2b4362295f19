"""Sub-tile row banding (``RasterizerConfig.bin_subtile``) in the PyTorch
port against the port at ``bin_subtile=1`` and against the JAX package.

The scene is ``tests/test_gbuffer.py``'s banding case: the 10,082-triangle
grid, 2 views at 152x160, so the band grid covers the padded tile grid.
Each side sizes its budgets with ``auto_fast_config`` at the band grid and
both configs must agree. The JAX render runs op by op
(``jax.disable_jit``): jitted, XLA contracts the setup's multiply-adds and
moves a few pixels (``tests/test_torch_port_render.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu as wr
from worldrenderer_tpu.mesh import make_grid_mesh
from worldrenderer_tpu.ops.gbuffer import rasterize_gbuffer as j_gbuffer
from worldrenderer_tpu.ops.rasterize import (
    FAST_TPU_CONFIG as J_FAST,
    auto_fast_config as j_auto_fast_config,
    binning_stats as j_binning_stats,
)
from worldrenderer_tpu.transforms import get_clip_space_position as j_clip

import worldrenderer_tpu_torch as pt

from test_torch_kernel_designs import one_torch_thread  # noqa: F401  (fixture)

# The port's plain versions on one thread: beside other test processes
# their intra-op threads would wait on each other.
pytestmark = pytest.mark.usefixtures("one_torch_thread")

RES = (152, 160)
CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def scene():
    """(JAX clip positions, JAX faces, port clip positions, port faces,
    per-vertex values (V, 3)) from numpy state."""
    verts, faces = make_grid_mesh(72)
    verts, faces = verts.astype(np.float32), faces.astype(np.int32)
    jcam = wr.get_camera(elevation_deg=35.0, distance=2.2, fovy_deg=50.0,
                         num_views=2, near=0.1, far=10.0)
    pcam = pt.camera_from_arrays(*(_np(getattr(jcam, f)) for f in CAM_FIELDS),
                                 device="cpu")
    vals = np.random.default_rng(8).standard_normal(
        (verts.shape[0], 3)).astype(np.float32)
    mesh = pt.mesh_from_arrays(verts, faces, device="cpu")
    return (j_clip(jnp.asarray(verts), jcam.mvp_mtx), jnp.asarray(faces),
            pt.get_clip_space_position(mesh.v_pos, pcam.mvp_mtx),
            mesh.t_pos_idx, vals)


def _configs(scene, sub):
    jpos, jtri, ppos, ptri, _ = scene
    jcfg = j_auto_fast_config(jpos, jtri, RES,
                              base=J_FAST._replace(bin_subtile=sub))
    pcfg = pt.auto_fast_config(ppos, ptri, RES,
                               base=pt.FAST_TPU_CONFIG._replace(bin_subtile=sub))
    assert tuple(pcfg) == tuple(jcfg)
    return jcfg._replace(dot_precision="highest"), pcfg


def _port(scene, cfg):
    _, _, ppos, ptri, vals = scene
    return pt.rasterize_gbuffer(ppos, ptri, torch.from_numpy(vals), RES, cfg,
                                device="cpu")


def _assert_equal(a, b):
    for f in ("mask", "tri_id", "z", "attr"):
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)),
                                      err_msg=f)


def _assert_matches_jax(ours, ref):
    """Mask and ids equal; z and the attributes within the tolerances
    between the JAX package's own backends (tests/test_gbuffer.py)."""
    for f in ("mask", "tri_id"):
        np.testing.assert_array_equal(_np(getattr(ours, f)),
                                      _np(getattr(ref, f)), err_msg=f)
    for f, atol in (("z", 1e-5), ("attr", 5e-4)):
        np.testing.assert_allclose(_np(getattr(ours, f)), _np(getattr(ref, f)),
                                   atol=atol, rtol=0, err_msg=f)


def _assert_within_flip_budget(ours, ref):
    """Against the jitted JAX render, whose FMA contractions move z planes
    and a few pixels: mask and id flips at most 1e-4 of the foreground, the
    only tolerance (as ``tests/test_torch_port_slice.py`` holds it)."""
    budget = 1e-4 * _np(ref.mask).sum()
    assert (_np(ours.mask) != _np(ref.mask)).sum() <= budget
    assert (_np(ours.tri_id) != _np(ref.tri_id)).sum() <= budget


@pytest.mark.parametrize("sub, jitted", [(2, False), (4, True)])
def test_bin_subtile_bit_equal_to_one_and_to_jax(scene, sub, jitted):
    """The banded render equals the unbanded one bit for bit (each lossless
    at its own grid), and the JAX package's banded render: op by op, mask
    and ids equal and z and values within the JAX backends' tolerances;
    jitted, within the flip budget."""
    _, pcfg1 = _configs(scene, 1)
    jcfg, pcfg = _configs(scene, sub)
    assert pt.binning_stats(scene[2], scene[3], RES, pcfg)["ok"]
    ours = _port(scene, pcfg)
    assert ours.mask.sum() > 0.3 * ours.mask.numel()
    _assert_equal(ours, _port(scene, pcfg1))
    args = (scene[0], scene[1], jnp.asarray(scene[4]), RES, jcfg)
    if jitted:
        _assert_within_flip_budget(ours, j_gbuffer(*args))
        return
    with jax.disable_jit():
        ref = j_gbuffer(*args)
    _assert_matches_jax(ours, ref)


@pytest.mark.parametrize("sub", [2, 4])
def test_binning_stats_counts_at_the_band_grid(scene, sub):
    """binning_stats classifies and counts at the band grid, as the JAX
    package's guard does: the same dict for the same config, and a band
    bin holds fewer entries than a tile."""
    jpos, jtri, ppos, ptri, _ = scene
    base = pt.FAST_TPU_CONFIG._replace(bin_huge=64, bin_med=0)
    ours = pt.binning_stats(ppos, ptri, RES, base._replace(bin_subtile=sub))
    ref = j_binning_stats(jpos, jtri, RES,
                          J_FAST._replace(bin_huge=64, bin_med=0,
                                          bin_subtile=sub))
    assert ours == {k: (bool(v) if k == "ok" else int(v)) for k, v in ref.items()}
    assert ours["max_per_tile"] < pt.binning_stats(ppos, ptri, RES,
                                                   base)["max_per_tile"]


def test_bin_subtile_that_does_not_divide_tile_h_raises_on_k1_only(scene):
    """sub = 3 does not divide tile_h = 16: the K1 route raises naming the
    field; the per-tile route (``fused_xla``) and a render below the flat
    path accept it and ignore it."""
    _, _, ppos, ptri, vals = scene
    cfg = pt.FAST_TPU_CONFIG._replace(bin_subtile=3)
    with pytest.raises(ValueError, match="bin_subtile"):
        pt.rasterize_gbuffer(ppos, ptri, None, RES, cfg, device="cpu")
    small = (32, 32)
    tri = ptri[:3000]  # below bin_sort_pairs_min_tris: the per-tile path
    for c, t in ((cfg._replace(backend="fused_xla", tile_w=32), ptri),
                 (cfg._replace(tile_w=32), tri)):
        on = pt.rasterize_gbuffer(ppos, t, None, small, c, device="cpu")
        off = pt.rasterize_gbuffer(ppos, t, None, small,
                                   c._replace(bin_subtile=1), device="cpu")
        _assert_equal(on, off)
