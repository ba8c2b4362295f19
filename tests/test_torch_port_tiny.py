"""The port's sub-pixel sort path (``RasterizerConfig.bin_tiny_px``) and its
budgets against the JAX package.

A scene of the class of ``tests/test_rasterize.py:778 _mixed_tiny_scene``
(big triangles and sub-pixel ones with independent vertices and random
depths) at 8,000 sub-pixel triangles, so above the flat path's 4,096, one
view at 128²:

  * ``rasterize_gbuffer`` with the sort path on, for ``auto`` (the port's
    K1; the JAX package's accelerator ``auto`` is its DMA kernel,
    ``fused_pallas``), ``vpu_pallas`` (K3) and ``fused_xla`` (K2), with and
    without attributes, against the JAX package run op by op (its tile
    kernels and ``_zattr_tile_xla`` jitted: their plane dots and
    reductions round alike jitted or not): masks and ids equal, z within
    1e-5, attributes within 5e-4;
  * bit for bit on the port: the candidate cap on against off, and the
    sort path on against off (``docs/PERF.md`` §7: exact mode is
    bit-identical);
  * ``binning_stats`` and ``auto_fast_config`` equal to the JAX package's,
    with the cap guard and the automatic trigger (301,088 triangles, 2
    views at 256²);
  * the -0 / +0 order of the sort and of the merge, ``bin_tiny_px > 1``
    raising, and classic ``rasterize`` with the path on.

The JAX reference renders are cached for the module, and torch runs on
one thread."""

import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu as wr
import worldrenderer_tpu.ops.gbuffer  # noqa: F401  (sys.modules below)
import worldrenderer_tpu.ops.gbuffer_pallas  # noqa: F401
import worldrenderer_tpu.ops.rasterize  # noqa: F401
from worldrenderer_tpu.mesh import make_grid_mesh
from worldrenderer_tpu.transforms import get_clip_space_position as j_clip

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch.ops import gbuffer as pg
from worldrenderer_tpu_torch.ops import gbuffer_cuda, zattr_cuda

jr = sys.modules["worldrenderer_tpu.ops.rasterize"]
jg = sys.modules["worldrenderer_tpu.ops.gbuffer"]
jgp = sys.modules["worldrenderer_tpu.ops.gbuffer_pallas"]

SIZE = 128
# The port's backend name beside the JAX package's name for the same kernel.
BACKENDS = {"auto": "fused_pallas", "vpu_pallas": "vpu_pallas",
            "fused_xla": "fused_xla"}
TINY = dict(bin_tiny_px=1.0, bin_flat_cap_abs=1 << 15)


@pytest.fixture
def one_torch_thread():
    """Torch on one thread: beside other test processes on the same cores,
    the intra-op threads of the plain versions would wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _scene(n_big=60, n_tiny=8000, seed=0):
    """(pos (1, V, 4) clip positions, tri (T, 3) int32, attr (V, 5)): big
    triangles first, then sub-pixel ones, each with its own vertices."""
    rng = np.random.default_rng(seed)

    def tris(n, half):
        centre = rng.uniform(-0.95, 0.95, (n, 2))
        xy = centre[:, None, :] + rng.uniform(-half, half, (n, 3, 2))
        return np.concatenate(
            [xy, rng.uniform(0.2, 0.9, (n, 3, 1)), np.ones((n, 3, 1))], -1)

    v = np.concatenate([tris(n_big, 0.3), tris(n_tiny, 0.006)])
    v = v.reshape(1, -1, 4).astype(np.float32)
    tri = np.arange(v.shape[1]).reshape(-1, 3).astype(np.int32)
    attr = rng.normal(size=(v.shape[1], 5)).astype(np.float32)
    return v, tri, attr


def _port_cfg(backend, **kw):
    return pt.RasterizerConfig(backend=backend, **kw)


@contextlib.contextmanager
def _op_by_op():
    """The JAX package op by op, its tile kernels and ``_zattr_tile_xla``
    jitted (the Pallas kernels in interpret mode)."""
    saved = []

    def patch(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    for name in ("zattr_tiles_vpu", "zattr_tiles_pallas", "gbuffer_tiles_dma"):
        def kernel(*args, _k=getattr(jgp, name), **kw):
            with jax.disable_jit(False):
                return _k(*args, **kw)

        patch(jgp, name, kernel)
    xla = jax.jit(jg._zattr_tile_xla, static_argnums=(1, 2, 3, 4, 5))

    def zattr_tile_xla(*args):
        with jax.disable_jit(False):
            return xla(*args)

    patch(jg, "_zattr_tile_xla", zattr_tile_xla)
    try:
        with jax.disable_jit():
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@functools.lru_cache(maxsize=None)
def _reference(j_backend, with_attr):
    pos, tri, attr = _scene()
    cfg = jr.RasterizerConfig(backend=j_backend, dot_precision="highest", **TINY)
    with _op_by_op():
        out = jg.rasterize_gbuffer(jnp.asarray(pos), jnp.asarray(tri),
                                   jnp.asarray(attr) if with_attr else None,
                                   (SIZE, SIZE), cfg)
    return {f: None if getattr(out, f) is None else _np(getattr(out, f))
            for f in ("mask", "tri_id", "z", "attr")}


def _port(backend, with_attr, **kw):
    pos, tri, attr = _scene()
    out = pt.rasterize_gbuffer(torch.tensor(pos), torch.tensor(tri),
                               torch.tensor(attr) if with_attr else None,
                               (SIZE, SIZE), _port_cfg(backend, **kw),
                               device="cpu")
    return {f: None if getattr(out, f) is None else _np(getattr(out, f))
            for f in ("mask", "tri_id", "z", "attr")}


@pytest.mark.parametrize("with_attr", [False, True])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_tiny_path_matches_jax_op_by_op(backend, with_attr, one_torch_thread):
    got = _port(backend, with_attr, **TINY)
    want = _reference(BACKENDS[backend], with_attr)
    st = pt.binning_stats(torch.tensor(_scene()[0]), torch.tensor(_scene()[1]),
                          (SIZE, SIZE), _port_cfg(backend, **TINY))
    assert st["ok"] and st["n_tiny_cov"] > 300  # the sort path is live
    assert got["mask"].sum() > 0.3 * got["mask"].size
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_array_equal(got["tri_id"], want["tri_id"])
    np.testing.assert_allclose(got["z"], want["z"], atol=1e-5, rtol=0)
    if with_attr:
        np.testing.assert_allclose(got["attr"], want["attr"], atol=5e-4, rtol=0)
    else:
        assert got["attr"] is None and want["attr"] is None


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_tiny_cap_and_tiny_path_are_bit_identical(backend, one_torch_thread):
    """The candidate cap, sized to hold every covered candidate, changes
    no bit. The sort path against none: on K1's path every bit is equal,
    since the sort path evaluates its planes in K1's order; K2 and K3
    round their planes with an FMA (``fma(b, ly, a*lx) + g``, ``fma(lx, a,
    ly*b) + g``), so there the same triangles win every pixel, and z and
    the attributes agree to the round-off of a sub-pixel triangle's steep
    planes (gradients near 1 / bbox, which magnify a last-bit
    difference)."""
    pos, tri, _ = _scene()
    st = pt.binning_stats(torch.tensor(pos), torch.tensor(tri), (SIZE, SIZE),
                          _port_cfg(backend, **TINY))
    cov = st["n_tiny_cov"]
    assert 0 < cov < tri.shape[0]
    cap = -(-cov // 256) * 256
    capped = _port(backend, True, bin_tiny_cap=cap, **TINY)
    uncapped = _port(backend, True, **TINY)
    off = _port(backend, True)
    for f in ("mask", "tri_id", "z", "attr"):
        np.testing.assert_array_equal(_bits(capped[f]), _bits(uncapped[f]),
                                      err_msg=f)
    exact = ("mask", "tri_id", "z", "attr") if backend == "auto" else (
        "mask", "tri_id")
    for f in exact:
        np.testing.assert_array_equal(_bits(uncapped[f]), _bits(off[f]),
                                      err_msg=f)
    np.testing.assert_allclose(uncapped["z"], off["z"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(uncapped["attr"], off["attr"], atol=5e-4, rtol=0)


def test_binning_stats_and_cap_guard_match_jax():
    pos, tri, _ = _scene(n_big=30, n_tiny=8000, seed=8)
    for kw in ({}, dict(bin_tiny_px=0.5),
               dict(bin_tiny_px=1.0, bin_tiny_cap=64, bin_small_cap=16,
                    bin_flat_cap_abs=64)):
        jcfg = jr.FAST_TPU_CONFIG._replace(**kw)
        want = jr.binning_stats(jnp.asarray(pos), jnp.asarray(tri),
                                (SIZE, SIZE), jcfg)
        got = pt.binning_stats(torch.tensor(pos), torch.tensor(tri),
                               (SIZE, SIZE),
                               pt.config_from_dict(jcfg._asdict()))
        assert got == want, kw
    assert want["n_tiny_cov"] > 64 and not want["ok"]  # the guard trips
    base = pt.FAST_TPU_CONFIG._replace(bin_tiny_px=1.0)
    cfg = pt.auto_fast_config(torch.tensor(pos), torch.tensor(tri),
                              (SIZE, SIZE), base=base)
    jcfg = jr.auto_fast_config(jnp.asarray(pos), jnp.asarray(tri),
                               (SIZE, SIZE),
                               base=jr.FAST_TPU_CONFIG._replace(bin_tiny_px=1.0))
    assert tuple(cfg) == tuple(jcfg)
    assert 0 < cfg.bin_tiny_cap < tri.shape[0] and cfg.bin_flat_cap_abs > 0
    assert cfg.bin_small_cap > 0


def test_auto_fast_config_trips_the_sort_path_as_jax_does():
    """The smallest grid over the trigger (300k triangles, 60% sub-pixel):
    389² vertices, 301,088 triangles, 2 views at 256²."""
    verts, faces = make_grid_mesh(
        389, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y))
    assert faces.shape[0] == 301_088
    cam = wr.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                        num_views=2, near=0.1, far=10.0)
    pos = j_clip(jnp.asarray(verts, jnp.float32), cam.mvp_mtx)
    tri = jnp.asarray(faces, jnp.int32)
    ppos, ptri = torch.tensor(_np(pos)), torch.tensor(faces)
    want = jr.auto_fast_config(pos, tri, (256, 256))
    got = pt.auto_fast_config(ppos, ptri, (256, 256))
    assert tuple(got) == tuple(want)
    assert got.bin_tiny_px == 1.0
    assert got.bin_tiny_cap > 0 and got.bin_flat_cap_abs > 0
    off = pt.auto_fast_config(ppos, ptri, (256, 256), auto_tiny=False)
    assert off.bin_tiny_px == 0.0 and off.bin_tiny_cap == 0
    assert off.bin_flat_cap_abs == 0


def test_negative_zero_orders_before_positive_zero(one_torch_thread):
    """The sort orders z's bits, so at one pixel a -0 candidate beats a +0
    one whatever the ids; the merge with the tile image compares floats,
    where -0 == +0 and the lower id wins. The port's sort path and merge
    against the JAX package's."""
    t = 4
    rows = np.zeros((12, t + 1), np.float32)
    rows[2] = rows[5] = rows[8] = 1.0  # edges: constant planes, covered
    rows[9:12, 2] = -0.0  # triangle 2: z = -0
    # Triangles 0 and 1: z = +0 and +0.25, all four at pixel (5, 3).
    rows[11, 1] = 0.25
    bbox = np.tile(np.array([[5.2], [5.6], [3.1], [3.7]], np.float32), (1, t + 1))
    bbox[:, 3] = [40.3, 40.7, 9.2, 9.6]  # triangle 3 at pixel (40, 9)
    tiny = np.ones(t, bool)
    attr = np.arange(6 * (t + 1), dtype=np.float32).reshape(6, t + 1)
    # Jitted: every value here is exact, so no contraction can move it.
    j_tiny = jax.jit(jg._tiny_images, static_argnums=(4, 5, 6, 7))
    jz, jid, jv = (_np(x) for x in j_tiny(
        jnp.asarray(rows), jnp.asarray(attr), jnp.asarray(bbox),
        jnp.asarray(tiny), 16, 64, 16, 32))
    z, idm, vals = pg._tiny_images(
        torch.tensor(rows)[None], torch.tensor(attr)[None],
        torch.tensor(bbox)[None], torch.tensor(tiny)[None], 16, 64, 16, 32)
    np.testing.assert_array_equal(_np(z)[0].view(np.int32), jz.view(np.int32))
    np.testing.assert_array_equal(_np(idm)[0].astype(np.float32), jid)
    np.testing.assert_array_equal(_np(vals)[0], jv)
    assert int(idm[0, 3, 5]) == 2 and str(float(z[0, 3, 5])) == "-0.0"
    assert int(idm[0, 9, 40]) == 3
    # Against a tile image holding triangle 1 at +0 on that pixel, the
    # merge keeps the lower id.
    z_tile = torch.full((1, 16, 64), torch.inf)
    id_tile = torch.full((1, 16, 64), gbuffer_cuda.BACKGROUND_ID,
                         dtype=torch.int32)
    z_tile[0, 3, 5], id_tile[0, 3, 5] = 0.0, 1
    mz, mid, _ = pg._merge_zidvals(z_tile, id_tile, None, z, idm, None)
    jz, jid, _ = jg._merge_zidvals(jnp.asarray(_np(z_tile)[0]),
                                   jnp.asarray(_np(id_tile)[0]), None,
                                   jnp.asarray(_np(z)[0]),
                                   jnp.asarray(_np(idm)[0]), None)
    assert int(mid[0, 3, 5]) == 1
    np.testing.assert_array_equal(_np(mid)[0], _np(jid))
    np.testing.assert_array_equal(_np(mz)[0].view(np.int32), _np(jz).view(np.int32))


def test_tiny_px_above_one_raises():
    pos, tri, attr = _scene(n_big=4, n_tiny=1400, seed=1)
    for backend in BACKENDS:
        cfg = _port_cfg(backend, bin_tiny_px=1.5)
        with pytest.raises(ValueError, match="bin_tiny_px"):
            pt.rasterize_gbuffer(torch.tensor(pos), torch.tensor(tri), None,
                                 (64, 64), cfg, device="cpu")
        with pytest.raises(ValueError, match="bin_tiny_px"):
            jg.rasterize_gbuffer(jnp.asarray(pos), jnp.asarray(tri), None,
                                 (64, 64), jr.RasterizerConfig(
                                     backend=BACKENDS[backend], bin_tiny_px=1.5))
    # Classic rasterize below the flat path never reaches the sort path.
    rast = pt.rasterize(torch.tensor(pos), torch.tensor(tri), (64, 64),
                        _port_cfg("auto", bin_tiny_px=1.5), device="cpu")
    assert rast.shape == (1, 64, 64, 4)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_classic_rasterize_with_the_tiny_path_matches_jax(backend,
                                                          one_torch_thread):
    """Classic ``rasterize`` at scale goes through the G-buffer paths in uv
    mode, sort path included, as the JAX package's does (K1 for "pallas",
    K2 for "xla"); below the flat path it ignores ``bin_tiny_px``."""
    pos, tri, _ = _scene()
    jcfg = jr.RasterizerConfig(backend=backend, dot_precision="highest", **TINY)
    with _op_by_op():
        want = _np(jr.rasterize(jnp.asarray(pos), jnp.asarray(tri),
                                (SIZE, SIZE), jcfg))
    got = _np(pt.rasterize(torch.tensor(pos), torch.tensor(tri), (SIZE, SIZE),
                           pt.config_from_dict(jcfg._asdict()), device="cpu"))
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=5e-4, rtol=0)
    off = _np(pt.rasterize(torch.tensor(pos), torch.tensor(tri), (SIZE, SIZE),
                           pt.RasterizerConfig(backend=backend), device="cpu"))
    if backend == "pallas":  # K1's rounding order: every bit equal
        np.testing.assert_array_equal(_bits(got), _bits(off))
    np.testing.assert_array_equal(got[..., 3], off[..., 3])
    np.testing.assert_allclose(got, off, atol=5e-4, rtol=0)
    small_pos, small_tri, _ = _scene(n_big=10, n_tiny=1000, seed=2)
    on = pt.rasterize(torch.tensor(small_pos), torch.tensor(small_tri),
                      (SIZE, SIZE), pt.RasterizerConfig(backend=backend, **TINY),
                      device="cpu")
    off = pt.rasterize(torch.tensor(small_pos), torch.tensor(small_tri),
                       (SIZE, SIZE), pt.RasterizerConfig(backend=backend),
                       device="cpu")
    np.testing.assert_array_equal(_np(on), _np(off))
    assert zattr_cuda.BACKGROUND_ID == float(gbuffer_cuda.BACKGROUND_ID)
