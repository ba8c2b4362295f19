"""The port's per-tile backends at the flat path against the JAX package.

At ``bin_sort_pairs_min_tris`` (4,096) triangles or more, the JAX
package's ``rasterize_gbuffer`` runs its DMA kernel for ``fused_pallas``
alone. Every other backend bins flat and then evaluates dense per-tile
rows cut from the sorted list (``_gather_tile_rows_flat``):
``vpu_pallas`` with the broadcast-FMA kernel (K3), ``fused_xla`` with
``_zattr_tile_xla``, whose contract is K2's. Classic ``rasterize`` takes
the same rows in uv mode for its "xla" backends. The port routes the
same way; these tests hold it to that on the headline heightfield (10,082
triangles), one view at 256², tiles of 16x128 and a per-tile cap of 1,536
(the fast config's), with planar UVs as the attributes:

  * which kernel each backend name reaches, on both entry points;
  * the port's flat-binned rows against the JAX package's, and K2's and
    K3's plain versions on those rows against the Pallas kernels in
    interpret mode, bit for bit;
  * the whole ``rasterize_gbuffer`` (``vpu_pallas``, ``fused_xla``) and
    ``rasterize`` (``xla``) against the JAX package run op by op, its
    kernels and ``_zattr_tile_xla`` jitted (their plane dots and
    reductions round alike jitted or not; the setup's multiply-adds do
    not, see ``tests/test_torch_port_tiles.py``): masks, ids, z and
    attributes equal.

The JAX reference renders are cached for the module and shared by the
tests, and torch runs on one thread."""

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
from worldrenderer_tpu_torch.ops import zattr_cuda as pz

jr = sys.modules["worldrenderer_tpu.ops.rasterize"]
jg = sys.modules["worldrenderer_tpu.ops.gbuffer"]
jgp = sys.modules["worldrenderer_tpu.ops.gbuffer_pallas"]

SIZE = 256
CFG = jr.RasterizerConfig(tile_h=16, max_tris_per_tile=1536)
KERNELS = {"gbuffer_tiles": "K1", "zattr_tiles": "K2", "zattr_tiles_vpu": "K3"}


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
def _scene():
    """(pos (1, V, 4) clip positions, faces (T, 3), uv (V, 2)): view 0 of
    the headline orbit, planar UVs as config4 makes them."""
    verts, faces = make_grid_mesh(
        72, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y))
    verts, faces = verts.astype(np.float32), faces.astype(np.int32)
    uv = ((verts[:, :2] - verts[:, :2].min(0)) / np.ptp(verts[:, :2], 0))
    cam = wr.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                        num_views=6, near=0.1, far=10.0)[[0]]
    pos = np.asarray(j_clip(jnp.asarray(verts), cam.mvp_mtx))
    return pos, faces, uv.astype(np.float32)


@contextlib.contextmanager
def _op_by_op():
    """The JAX package op by op, its tile kernels and ``_zattr_tile_xla``
    jitted (the Pallas kernels in interpret mode)."""
    saved = []

    def patch(mod, name, jitted):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, jitted)

    for name in ("zattr_tiles_vpu", "zattr_tiles_pallas"):
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
def _reference(entry, backend):
    pos, faces, uv = _scene()
    cfg = CFG._replace(backend=backend)
    with _op_by_op():
        if entry == "rasterize":
            return {"rast": _np(jr.rasterize(jnp.asarray(pos), jnp.asarray(faces),
                                             (SIZE, SIZE), cfg))}
        out = jg.rasterize_gbuffer(jnp.asarray(pos), jnp.asarray(faces),
                                   jnp.asarray(uv), (SIZE, SIZE), cfg)
    return {f: _np(getattr(out, f)) for f in ("mask", "tri_id", "z", "attr")}


@functools.lru_cache(maxsize=None)
def _port(entry, backend):
    pos, faces, uv = (torch.from_numpy(a.copy()) for a in _scene())
    cfg = pt.config_from_dict(CFG._replace(backend=backend)._asdict())
    if entry == "rasterize":
        return {"rast": _np(pt.rasterize(pos, faces, (SIZE, SIZE), cfg,
                                         device="cpu"))}
    out = pt.rasterize_gbuffer(pos, faces, uv, (SIZE, SIZE), cfg, device="cpu")
    return {f: _np(getattr(out, f)) for f in ("mask", "tri_id", "z", "attr")}


class _Routed(Exception):
    pass


@pytest.mark.parametrize("backend, kernel", [
    ("auto", "gbuffer_tiles"), ("fused_pallas", "gbuffer_tiles"),
    ("pallas", "gbuffer_tiles"), ("vpu_pallas", "zattr_tiles_vpu"),
    ("fused_xla", "zattr_tiles"), ("xla", "zattr_tiles"),
])
@pytest.mark.parametrize("entry", ["rasterize_gbuffer", "rasterize"])
def test_flat_path_routes_by_backend(monkeypatch, entry, backend, kernel):
    """Each backend name reaches the kernel the JAX package's routing
    gives it on the flat path (its accelerator's "auto" is "fused_pallas"
    and "pallas"). Classic ``rasterize`` maps the names first, as the JAX
    package's ``_resolve_backend`` does: "vpu_pallas" is a "pallas" name
    there and runs K1; the "xla" names run K2 in uv mode."""
    if entry == "rasterize" and backend == "vpu_pallas":
        kernel = "gbuffer_tiles"
    for name in KERNELS:
        def spy(*args, _name=name):
            raise _Routed(_name)

        monkeypatch.setattr(pg, name, spy)
    pos, faces, uv = (torch.from_numpy(a.copy()) for a in _scene())
    cfg = pt.RasterizerConfig(backend=backend, tile_h=16)
    with pytest.raises(_Routed) as hit:
        if entry == "rasterize":
            pt.rasterize(pos, faces, (64, 128), cfg, device="cpu")
        else:
            pt.rasterize_gbuffer(pos, faces, uv, (64, 128), cfg, device="cpu")
    assert str(hit.value) == kernel, KERNELS[str(hit.value)]


@functools.lru_cache(maxsize=None)
def _rows():
    """The port's flat-binned tile rows and the JAX package's, the latter
    from its own stages as its ``_gbuffer_single`` calls them, vmapped over
    the view like the render (so the op-by-op primitives are shared)."""
    pos, faces, uv = _scene()
    cfg = CFG
    n_ty, n_tx = SIZE // cfg.tile_h, SIZE // cfg.tile_w
    t_total = faces.shape[0]
    k_cap = min(cfg.max_tris_per_tile, t_total)
    tri = jnp.asarray(faces)

    def rows(p):
        s = jr._triangle_setup(p, tri, SIZE, SIZE, backface_cull=0)
        id_plane = jnp.zeros((t_total + 1, 1, 3), jnp.float32).at[:, 0, 2].set(
            jnp.arange(t_total + 1, dtype=jnp.float32))
        allp = jnp.concatenate(
            [s.planes, id_plane, jg._attr_planes(s, tri, jnp.asarray(uv))], axis=1)
        tile_ix = jnp.arange(n_ty * n_tx, dtype=jnp.int32)
        origin = jnp.stack([(tile_ix % n_tx * cfg.tile_w).astype(jnp.float32),
                            (tile_ix // n_tx * cfg.tile_h).astype(jnp.float32)],
                           axis=-1)
        flat = jr._bin_flat(
            s, SIZE, SIZE, cfg.tile_h, cfg.tile_w, cfg.bin_span_tiles_y,
            cfg.bin_span_tiles_x, cfg.bin_huge, cfg.bin_flat_cap_factor,
            n_med=cfg.bin_med, med_span_y=cfg.bin_med_span_y,
            med_span_x=cfg.bin_med_span_x, tiny_px=cfg.bin_tiny_px,
            cap_abs=cfg.bin_flat_cap_abs, small_cap=cfg.bin_small_cap)
        return jg._gather_tile_rows_flat(allp, s.valid, flat, origin, k_cap,
                                         n_tx=n_tx, tile_w=cfg.tile_w,
                                         tile_h=cfg.tile_h)

    with _op_by_op():
        jco, jcnt = jax.vmap(rows)(jnp.asarray(pos))
    (co, cnt), dims, _ = pg._zattr_inputs(
        *(torch.from_numpy(a.copy()) for a in (pos, faces, uv)), SIZE, SIZE,
        pt.config_from_dict(cfg._asdict()))
    return (_np(jco).reshape(co.shape), _np(jcnt).reshape(-1)), (co, cnt), dims


@pytest.mark.usefixtures("one_torch_thread")
def test_flat_tile_rows_match_jax():
    """``_zattr_inputs`` on the flat path against the JAX package's
    ``_gather_tile_rows_flat`` on its own setup and flat binning: each
    tile's window of k_cap = 1,536 entries (not the automatic cap), its
    planes rebased to each entry's own tile, e0 constants of -3e38 past
    the count, bit for bit."""
    (jco, jcnt), (co, cnt), dims = _rows()
    assert co.shape[2] == (5 + dims[0]) * 1536
    np.testing.assert_array_equal(_np(cnt), jcnt)
    np.testing.assert_array_equal(_np(co), jco)
    assert 0 < int(cnt.max()) <= 1536 and int(cnt.sum()) > 5000


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("kernel, jax_kernel", [
    ("zattr_tiles_vpu", "zattr_tiles_vpu"), ("zattr_tiles", "zattr_tiles_pallas")])
def test_tile_kernels_on_flat_rows_match_pallas(kernel, jax_kernel):
    """K3's and K2's plain versions on the flat-binned rows against the
    Pallas kernels in interpret mode: z (K2's sign too), ids and values bit
    for bit."""
    _, (co, cnt), dims = _rows()
    ref = getattr(jgp, jax_kernel)(jnp.asarray(_np(co)), jnp.asarray(_np(cnt)),
                                   *dims)
    ours = getattr(pz, kernel)(co, cnt, *dims)
    for what, o, r in zip(("z", "id", "vals"), ours, ref):
        np.testing.assert_array_equal(_np(o), _np(r), err_msg=what)
    if kernel == "zattr_tiles":
        np.testing.assert_array_equal(np.signbit(_np(ours[0])),
                                      np.signbit(_np(ref[0])))
    assert np.isfinite(_np(ref[0])).sum() > 10_000


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("entry, backend", [
    ("rasterize_gbuffer", "vpu_pallas"), ("rasterize_gbuffer", "fused_xla"),
    ("rasterize", "xla")])
def test_flat_backends_match_jax(entry, backend):
    """The whole entry point against the JAX package's same backend, run
    op by op: masks and ids equal, z and attributes (``rasterize``: u, v,
    z and id) bit for bit."""
    ref, out = _reference(entry, backend), _port(entry, backend)
    for f, r in ref.items():
        np.testing.assert_array_equal(out[f], r, err_msg=f)
    fg = (ref["rast"][..., 3] > 0) if entry == "rasterize" else ref["mask"]
    assert fg.sum() > 20_000


@pytest.mark.usefixtures("one_torch_thread")
def test_vpu_pallas_parts_from_k1_where_jax_does():
    """K3's own rounding and tie rule on the flat rows: the port's
    ``vpu_pallas`` ids part from its K1 (``fused_pallas``) ids at the
    pixels where the JAX package's ``vpu_pallas`` parts from them, and
    ``fused_xla`` (K2) agrees with ``vpu_pallas`` where the JAX package's
    does."""
    k1 = _port("rasterize_gbuffer", "fused_pallas")["tri_id"]
    vpu = _port("rasterize_gbuffer", "vpu_pallas")["tri_id"]
    xla = _port("rasterize_gbuffer", "fused_xla")["tri_id"]
    ref_vpu = _reference("rasterize_gbuffer", "vpu_pallas")["tri_id"]
    ref_xla = _reference("rasterize_gbuffer", "fused_xla")["tri_id"]
    assert (vpu != k1).any()
    np.testing.assert_array_equal(vpu != k1, ref_vpu != k1)
    np.testing.assert_array_equal(vpu != xla, ref_vpu != ref_xla)
