"""The port's per-tile path module by module against the JAX package, and
the whole slice at workload 1's full width.

Modules: the classic triangle setup, dense binning, the tile coefficient
gathers, the attribute planes, the (u, v) and derivative resolves, and the
plain versions of kernels K2, K3 and K4 against the JAX kernels
themselves. The JAX stage functions run op by op on the same numpy clip
coordinates, so everything must be equal bit for bit. The JAX kernels are
jitted and run in interpret mode, as the JAX package's own tests run them
on the CPU; each port kernel rounds its planes as its JAX kernel does (K2
and K4 as the fp32 plane dot, ``fma(b, ly, a*lx) + g``; K3 as XLA
contracts its elementwise form, ``fma(lx, a, ly*b) + g``), so z, ids and
values are held bit for bit too. The CUDA kernels are held against these
plain versions on the card by ``chip_smoke.py``, on the same synthetic
edge cases.

The whole slice: ``rasterize_gbuffer`` below the flat path with each
backend, and ``render()`` of the 3,968-triangle UV sphere at 512², against
the reference run op by op (the ``reference`` fixture) with two
adjustments, each to a rounding the port cannot follow at every shape:
  * its kernels run jitted, as the JAX package always runs them: op by op,
    K3's elementwise planes would round as separate products and sums,
    where jitted XLA contracts them into the FMAs the port's K3 follows;
  * ``render``'s clip transform runs on the vertices padded to 4,096.
    XLA's CPU matrix product rounds that 4-term dot in an order that
    depends on the vertex count: at 4,096 vertices as the chain of FMAs
    the port follows (``transforms.mvp_columns``), at the sphere's 2,080
    in another order, which changes the last bit of some clip coordinates
    and moves the planes of steep triangles: unpadded, the fused branch's
    positions move by up to 9.4e-3 and its depth by up to 1.3e-2
    (``tools/port_reference_spread.py``).
Then masks are equal, positions and depth within 1e-5 (most hold bit for
bit), normals bit for bit. Against the jitted reference, which differs
from its own op-by-op run (ROADMAP queue 3), masks are held to a flip
budget of 1e-4 of the foreground pixels and positions, depth and normals
to bounds set from that script's reading (``_JITTED_MAX``)."""

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
import worldrenderer_tpu.ops.rasterize_pallas  # noqa: F401
import worldrenderer_tpu.render  # noqa: F401
from worldrenderer_tpu.mesh import (
    compute_vertex_normals,
    icosphere,
    make_grid_mesh,
    uv_sphere_mesh,
)
from worldrenderer_tpu.ops.gbuffer_pallas import (
    zattr_tiles_pallas as j_zattr,
    zattr_tiles_vpu as j_zattr_vpu,
)
from worldrenderer_tpu.ops.rasterize_pallas import raster_zid_tiles_pallas as j_zid
from worldrenderer_tpu.transforms import get_clip_space_position as j_clip

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch.ops import gbuffer as pg
from worldrenderer_tpu_torch.ops import raster_zid_cuda as pk
import worldrenderer_tpu_torch.ops.rasterize  # noqa: F401  (sys.modules below)
from worldrenderer_tpu_torch.ops import zattr_cuda as pz
from worldrenderer_tpu_torch.utils.debug import counter_totals

from chip_smoke import (
    slot_tie_tile_inputs,
    synthetic_tile_inputs,
    zero_sign_tile_inputs,
    zid_tile_inputs,
)

# `worldrenderer_tpu.ops` re-exports functions named like the modules.
jr = sys.modules["worldrenderer_tpu.ops.rasterize"]
pr = sys.modules["worldrenderer_tpu_torch.ops.rasterize"]
jg = sys.modules["worldrenderer_tpu.ops.gbuffer"]
CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _height(x, y):
    return 0.3 * np.sin(3 * x) * np.cos(3 * y)


def scene(name):
    """(pos (B, V, 4) f32 clip positions, faces (T, 3) i32, verts (V, 3),
    H, W) for a named scene."""
    orbit = dict(elevation_deg=35.0, distance=3.0, fovy_deg=50.0, num_views=2,
                 near=0.1, far=10.0)
    if name == "icosphere":  # tests/test_gbuffer.py:18
        verts, faces = icosphere(2)
        cam = wr.get_camera(elevation_deg=20.0, distance=3.0, fovy_deg=45.0,
                            num_views=2, near=0.1, far=10.0)
        hw = (64, 128)
    elif name == "grid45":  # 3,872 triangles: K = 3872 is no multiple of 128
        verts, faces = make_grid_mesh(45, height_fn=_height)
        cam = wr.get_camera(**orbit)
        hw = (96, 256)
    elif name == "sphere":  # workload 1's mesh and orbit, two views
        verts, faces, _ = uv_sphere_mesh(32, 65)
        cam = wr.get_camera(elevation_deg=20.0, distance=2.7, fovy_deg=40.0,
                            num_views=6, near=0.1, far=10.0)[[0, 3]]
        hw = (128, 256)
    elif name == "crossing":  # camera inside the grid's extent: w <= 0 corners
        verts, faces = make_grid_mesh(72, height_fn=_height)
        cam = wr.get_camera(elevation_deg=25.0, distance=0.6, fovy_deg=70.0,
                            azimuth_deg=[10.0, 200.0], near=0.05, far=10.0)
        hw = (128, 256)
    elif name == "nan":  # one NaN vertex and one far behind the camera
        verts, faces = make_grid_mesh(45, height_fn=_height)
        verts[100] = np.nan
        verts[2000] = (-40.0, -40.0, -30.0)
        cam = wr.get_camera(**orbit)
        hw = (96, 128)
    else:
        raise KeyError(name)
    verts = verts.astype(np.float32)
    faces = faces.astype(np.int32)
    pos = _np(j_clip(jnp.asarray(verts), cam.mvp_mtx))
    return pos, faces, verts, hw[0], hw[1]


def _j_setups(pos, faces, w, h, backface_cull=0):
    return [jr._triangle_setup(jnp.asarray(p), jnp.asarray(faces), w, h,
                               backface_cull=backface_cull) for p in pos]


def _p_setup(pos, faces, w, h, backface_cull=0):
    return pr._triangle_setup(torch.from_numpy(pos), torch.from_numpy(faces),
                              w, h, backface_cull)


@pytest.mark.parametrize("name", ["icosphere", "sphere", "crossing", "nan"])
@pytest.mark.parametrize("backface_cull", [0, -1])
def test_triangle_setup_matches_jax(name, backface_cull):
    """The classic layout bit for bit, its einsum-rounded z plane included
    (NaN where the reference has NaN)."""
    pos, faces, _, h, w = scene(name)
    js = _j_setups(pos, faces, w, h, backface_cull)
    ps = _p_setup(pos, faces, w, h, backface_cull)
    for field in ("planes", "inv_w", "inv_area", "valid", "bbox"):
        np.testing.assert_array_equal(
            _np(getattr(ps, field)), np.stack([_np(getattr(s, field)) for s in js]),
            err_msg=field)


def _j_bins(js, w, h, cfg, k):
    out = [jr._bin_dispatch(s, w, h, cfg.tile_h, cfg.tile_w, k, cfg) for s in js]
    return np.stack([_np(o[0]) for o in out]), np.stack([_np(o[1]) for o in out])


@pytest.mark.parametrize("name, k", [("icosphere", 320), ("grid45", 3872),
                                     ("crossing", 700), ("nan", 3872)])
def test_bin_triangles_matches_jax(name, k):
    """Dense binning equals the reference's ``_bin_dispatch`` (its argsort
    branch; ``bin_mode="argsort"`` reaches it at any size), capped or not."""
    pos, faces, _, h, w = scene(name)
    cfg = jr.RasterizerConfig(bin_mode="argsort")
    ref_ids, ref_counts = _j_bins(_j_setups(pos, faces, w, h), w, h, cfg, k)
    ids, counts = pr._bin_triangles(_p_setup(pos, faces, w, h), w, h,
                                    cfg.tile_h, cfg.tile_w, k)
    np.testing.assert_array_equal(_np(ids), ref_ids)
    np.testing.assert_array_equal(_np(counts), ref_counts)
    assert ref_counts.max() > 0


def _origins(h, w, cfg):
    n_ty, n_tx = -(-h // cfg.tile_h), -(-w // cfg.tile_w)
    return n_ty, n_tx, pr._tile_origins(n_ty, n_tx, cfg.tile_h, cfg.tile_w, "cpu")


@functools.lru_cache(maxsize=None)
def _tile_blocks(name, n_attr):
    """Both packages' per-tile coefficient blocks for a scene: the JAX
    package's K4 block (B*n_tiles, 3, 4K), K2/K3 block (B*n_tiles, 3, R*K)
    with R = 5 + n_attr + 1, ids and counts; and the port's own (cached:
    the kernel tests share them)."""
    pos, faces, verts, h, w = scene(name)
    cfg = jr.RasterizerConfig()
    t_total = faces.shape[0]
    n_ty, n_tx, origin = _origins(h, w, cfg)
    k = jr._auto_cap(t_total, n_ty * n_tx)
    js = _j_setups(pos, faces, w, h)
    ref_ids, ref_counts = _j_bins(js, w, h, cfg, k)
    attr = np.random.default_rng(3).standard_normal(
        (verts.shape[0], n_attr)).astype(np.float32)
    jo = jnp.asarray(_np(origin))
    j4, jr_rows = [], []
    for s, ids in zip(js, ref_ids):
        j4.append(_np(jr._gather_tile_coeffs(s, jnp.asarray(ids), jo)))
        id_plane = jnp.zeros((t_total + 1, 1, 3)).at[:, 0, 2].set(
            jnp.arange(t_total + 1, dtype=jnp.float32))
        ap = jg._attr_planes(s, jnp.asarray(faces), jnp.asarray(attr))
        allp = jnp.concatenate([s.planes, id_plane, ap], axis=1)
        jr_rows.append(_np(jg._gather_tile_rows(allp, s.valid, jnp.asarray(ids), jo)))
    tpos, tfaces = torch.from_numpy(pos), torch.from_numpy(faces)
    pcfg = pt.config_from_dict(cfg._asdict())
    _, (p4, ids, counts), _ = pr._zid_inputs(tpos, tfaces, h, w, pcfg)
    (p_rows, counts2), _, _ = pg._zattr_inputs(
        tpos, tfaces, torch.from_numpy(attr), h, w, pcfg)
    assert torch.equal(counts, counts2)
    ref = (np.concatenate(j4), np.concatenate(jr_rows), ref_ids.reshape(-1, k),
           ref_counts.reshape(-1))
    return ref, (p4, p_rows, ids, counts), (cfg.tile_h, cfg.tile_w)


@pytest.mark.parametrize("name", ["icosphere", "grid45"])
def test_tile_gathers_match_jax(name):
    """The kernels' inputs as the per-tile paths build them
    (``_zid_inputs``, ``_zattr_inputs``) against the reference's
    ``_gather_tile_coeffs``, ``_attr_planes`` and ``_gather_tile_rows``, bit
    for bit: rebased constants, the -3e38 e0 of invalid entries, the
    constant id plane and the einsum-rounded attribute planes."""
    ref, ours, _ = _tile_blocks(name, 3)
    for r, o, what in zip(ref, ours, ("coeffs", "rows", "ids", "counts")):
        np.testing.assert_array_equal(_np(o).reshape(r.shape), r, err_msg=what)


def test_attr_planes_uv_one_hots_match_jax():
    """uv mode's one-hot corner attributes through the classic attribute
    planes, and ``_uv_corner_attrs_t`` against the reference's."""
    pos, faces, _, h, w = scene("sphere")
    t_total = faces.shape[0]
    a = pg._uv_corner_attrs_t(t_total)
    np.testing.assert_array_equal(_np(a), _np(jg._uv_corner_attrs_t(t_total)))
    js = _j_setups(pos, faces, w, h)
    ja = jnp.broadcast_to(jnp.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])[None],
                          (t_total, 3, 2))
    ref = np.stack([_np(jg._attr_planes(s, jnp.asarray(faces), jnp.zeros((1, 2)),
                                        a=ja)) for s in js])
    ours = pg._attr_planes(_p_setup(pos, faces, w, h), a.permute(2, 1, 0))
    np.testing.assert_array_equal(_np(ours), ref)


def _synthetic():
    co, co4, ids, counts = synthetic_tile_inputs("cpu")
    return co, co4, ids, counts, (16, 128)


def _same_bits(ours, ref, what):
    """Values equal and z's sign too (``assert_array_equal`` counts -0
    equal to +0)."""
    np.testing.assert_array_equal(_np(ours), _np(ref), err_msg=what)
    np.testing.assert_array_equal(np.signbit(_np(ours)), np.signbit(_np(ref)),
                                  err_msg=f"{what}: sign bits")


@pytest.mark.parametrize("name", ["icosphere", "grid45", "synthetic",
                                  "zero_signs"])
def test_raster_zid_plain_matches_jax_kernel(name):
    """K4's plain version against ``raster_zid_tiles_pallas`` (interpret
    mode) on the same blocks: z (its sign included) and ``id + 1`` bit for
    bit; the synthetic case's ties resolve to the least slot. In the
    zero-sign case (``zero_sign_tile_inputs``' four geometry blocks) every
    pixel's z is a tie at zero, some planes -0: the TPU kernel's plane dot
    accumulates from +0, so its z is +0 everywhere."""
    if name == "synthetic":
        _, co4, ids, counts, (th, tw) = _synthetic()
    elif name == "zero_signs":
        (co, counts), _, _ = zero_sign_tile_inputs("cpu")
        co4, ids, counts = zid_tile_inputs(co, counts, 2)
        th, tw = 16, 128
    else:
        (co4, _, ids, counts), _, (th, tw) = _tile_blocks(name, 1)
        co4, ids, counts = (torch.from_numpy(np.ascontiguousarray(x))
                            for x in (co4, ids, counts))
    jz, jid = j_zid(jnp.asarray(_np(co4)), jnp.asarray(_np(ids)),
                    jnp.asarray(_np(counts)), th, tw, 128)
    z, idm = pk.raster_zid_tiles(co4, ids, counts, th, tw, 128)
    _same_bits(z, jz, "z")
    np.testing.assert_array_equal(_np(idm), _np(jid))
    assert np.isfinite(_np(jz)).sum() > 1000
    if name == "synthetic":
        assert (_np(idm)[2] == int(ids[2, 5]) + 1).all()
        assert np.isinf(_np(z)[1]).all()
    elif name == "zero_signs":
        assert (_np(z) == 0).all() and not np.signbit(_np(z)).any()


@pytest.mark.parametrize("name", ["icosphere", "grid45", "synthetic",
                                  "slot_ties", "slot_ties_c256", "zero_signs"])
@pytest.mark.parametrize("kernel", ["zattr_tiles", "zattr_tiles_vpu"])
def test_zattr_plain_matches_jax_kernel(kernel, name):
    """K2's and K3's plain versions against ``zattr_tiles_pallas`` (exact
    fp32 dot) and ``zattr_tiles_vpu`` (interpret mode) on the same blocks:
    z, ids and values bit for bit. In the synthetic case's ties K2 takes
    the least id of the first chunk that reaches the least z, K3 the least
    id over all lane slots. In the slot-tie cases (c = 128 and 256) a lane
    slot that reached the least z keeps that entry against a later one of
    smaller id in the same slot. At -0 / +0 ties across slots (zero_signs)
    z agrees in value, and K3's TPU kernel gives -0 wherever a slot holds
    -0 (jnp.min orders -0 first), the rule the CUDA kernel keeps. K2's z is
    held with its sign on every case: its TPU kernel's plane dot
    accumulates from +0, so a covered z is never -0."""
    n_vals = 2
    chunk = 128
    winners = None
    if name == "synthetic":
        co, _, ids, counts, (th, tw) = _synthetic()
    elif name.startswith("slot_ties"):
        chunk = 256 if name.endswith("c256") else 128
        (co, counts), winners = slot_tie_tile_inputs("cpu", chunk)
        th, tw = 16, 128
    elif name == "zero_signs":
        (co, counts), winners, signs = zero_sign_tile_inputs("cpu")
        th, tw = 16, 128
    else:
        (_, co, _, counts), _, (th, tw) = _tile_blocks(name, n_vals - 1)
        co, counts = (torch.from_numpy(np.ascontiguousarray(x))
                      for x in (co, counts))
    jfn = j_zattr if kernel == "zattr_tiles" else j_zattr_vpu
    ref = jfn(jnp.asarray(_np(co)), jnp.asarray(_np(counts)), n_vals, th, tw,
              chunk)
    ours = getattr(pz, kernel)(co, counts, n_vals, th, tw, chunk)
    for what, o, r in zip(("z", "id", "vals"), ours, ref):
        np.testing.assert_array_equal(_np(o), _np(r), err_msg=what)
    if kernel == "zattr_tiles":
        _same_bits(ours[0], ref[0], "z")
    assert np.isfinite(_np(ref[0])).sum() > 1000
    if name == "synthetic":
        winner = {"zattr_tiles": 9, "zattr_tiles_vpu": 130}[kernel]
        assert (_np(ours[1])[2] == float(ids[2, winner])).all()
    elif winners is not None:
        idg = _np(co).reshape(4, 3, 5 + n_vals, -1)[:, 2, 4]
        for t, e in enumerate(winners[kernel]):
            assert (_np(ours[1])[t] == idg[t, e]).all(), t
    if name == "zero_signs" and kernel == "zattr_tiles_vpu":
        neg = np.signbit(_np(ref[0])).reshape(4, -1)
        assert [bool(n.all()) for n in neg] == signs
        assert [bool(n.any()) for n in neg] == signs


def test_resolves_match_jax():
    """``_resolve_uv`` and ``_resolve_db`` bit for bit against the
    reference run op by op, on the reference's own z/id images."""
    pos, faces, _, h, w = scene("sphere")
    js = _j_setups(pos, faces, w, h)
    rasts = [jr._rasterize_single(jnp.asarray(p), jnp.asarray(faces), h, w,
                                  jr.RasterizerConfig(backend="pallas"))
             for p in pos]
    idmap = np.stack([_np(r[..., 3]).astype(np.int32) for r in rasts])
    zmap = np.stack([_np(r[..., 2]) for r in rasts])
    ps = _p_setup(pos, faces, w, h)
    uv = pr._resolve_uv(ps, torch.from_numpy(idmap), torch.from_numpy(zmap))
    ref = np.stack([_np(jr._resolve_uv(s, jnp.asarray(i), jnp.asarray(z)))
                    for s, i, z in zip(js, idmap, zmap)])
    np.testing.assert_array_equal(_np(uv), ref)
    db = pr._resolve_db(ps, torch.from_numpy(idmap))
    ref_db = np.stack([_np(jr._resolve_db(s, jnp.asarray(i)))
                       for s, i in zip(js, idmap)])
    np.testing.assert_array_equal(_np(db), ref_db)
    assert (idmap > 0).sum() > 1000


@pytest.mark.parametrize("kernel", ["zattr_tiles", "zattr_tiles_vpu",
                                    "raster_zid_tiles"])
def test_tile_kernel_wrappers_take_plain_versions_on_cpu(kernel):
    """On CPU tensors each wrapper runs its plain version and counts no
    launch; it refuses wrong types and shapes."""
    co, co4, ids, counts = synthetic_tile_inputs("cpu")
    if kernel == "raster_zid_tiles":
        before = counter_totals().get("launch.k4", 0)
        got = pk.raster_zid_tiles(co4, ids, counts, 16, 128, 128)
        z, slot = pk.raster_zid_tiles_plain(co4, counts, 16, 128, 128)
        assert counter_totals().get("launch.k4", 0) == before
        assert torch.equal(got[0], z)
        assert torch.equal(got[1], pk.ids_from_slots(slot, ids))
        with pytest.raises(TypeError):
            pk.raster_zid_tiles(co4.double(), ids, counts, 16, 128, 128)
        with pytest.raises(ValueError):
            pk.raster_zid_tiles(co4[:, :, :-4].contiguous(), ids, counts, 16,
                                128, 128)
        return
    before = counter_totals()
    plain = getattr(pz, f"{kernel}_plain")
    for a, b in zip(getattr(pz, kernel)(co, counts, 2, 16, 128, 128),
                    plain(co, counts, 2, 16, 128, 128)):
        assert torch.equal(a, b)
    assert counter_totals() == before
    with pytest.raises(TypeError):
        getattr(pz, kernel)(co, counts.long(), 2, 16, 128, 128)
    with pytest.raises(ValueError):
        getattr(pz, kernel)(co, counts, 3, 16, 128, 128)


# ---- The whole slice: workload 1 at its full width --------------------------

@pytest.fixture
def reference(monkeypatch):
    """The JAX package op by op, its kernels jitted and ``render``'s clip
    transform on vertices padded to 4,096 (see the module docstring; the
    classic API's tests use it too)."""
    gp = sys.modules["worldrenderer_tpu.ops.gbuffer_pallas"]
    rp = sys.modules["worldrenderer_tpu.ops.rasterize_pallas"]
    for mod, name in ((gp, "zattr_tiles_vpu"), (gp, "zattr_tiles_pallas"),
                      (gp, "gbuffer_tiles_dma"), (rp, "raster_zid_tiles_pallas")):
        kernel = getattr(mod, name)

        def jitted(*args, _kernel=kernel, **kw):
            with jax.disable_jit(False):
                return _kernel(*args, **kw)

        monkeypatch.setattr(mod, name, jitted)

    def clip_padded(pos, mvp):
        n = pos.shape[0]
        return j_clip(jnp.pad(pos, ((0, 4096 - n), (0, 0))), mvp)[:, :n]

    monkeypatch.setattr(sys.modules["worldrenderer_tpu.render"],
                        "get_clip_space_position", clip_padded)
    with jax.disable_jit():
        yield


def _sphere512():
    """Workload 1's G-buffer inputs, views 0 and 3 of its six at 512² (the
    render tests' views: the reference's compiled ops are shared)."""
    verts, faces, _ = uv_sphere_mesh(32, 65)
    verts, faces = verts.astype(np.float32), faces.astype(np.int32)
    cam = wr.get_camera(elevation_deg=20.0, distance=2.7, fovy_deg=40.0,
                        num_views=6, near=0.1, far=10.0)[[0, 3]]
    pos = j_clip(jnp.pad(jnp.asarray(verts), ((0, 4096 - verts.shape[0]), (0, 0))),
                 cam.mvp_mtx)[:, :verts.shape[0]]
    return _np(pos), faces, verts, 512, 512


@pytest.mark.parametrize("backend, name", [
    ("fused_pallas", "icosphere"), ("vpu_pallas", "icosphere"),
    ("pallas", "icosphere"), ("vpu_pallas", "sphere512"),
])
def test_rasterize_gbuffer_per_tile_matches_jax(reference, backend, name):
    """Below the flat path: K2 (``fused_pallas``, ``pallas``) or K3
    (``vpu_pallas``) with positions and normals as attributes; workload 1's
    G-buffer through K3 at its full width."""
    pos, faces, verts, h, w = _sphere512() if name == "sphere512" else scene(name)
    nrm = _np(compute_vertex_normals(jnp.asarray(verts), jnp.asarray(faces)))
    v_attr = nrm if name == "sphere512" else np.concatenate([verts, nrm], axis=1)
    cfg = jr.RasterizerConfig(backend=backend)
    ref = jg.rasterize_gbuffer(jnp.asarray(pos), jnp.asarray(faces),
                               jnp.asarray(v_attr), (h, w), cfg)
    out = pt.rasterize_gbuffer(_t(pos), _t(faces), _t(v_attr), (h, w),
                               pt.config_from_dict(cfg._asdict()), device="cpu")
    for f in ("mask", "tri_id", "z", "attr"):
        np.testing.assert_array_equal(_np(getattr(out, f)), _np(getattr(ref, f)),
                                      err_msg=f)
    assert out.tri_id.dtype == torch.int32 and _np(ref.mask).sum() > 5000


@functools.lru_cache(maxsize=None)
def _sphere_both():
    """Workload 1's mesh and views 0 and 3 for both packages, the cameras
    built jitted even under the ``reference`` fixture: op by op they differ
    in the last bits, and the port's cached render must see the cameras
    each reference sees."""
    verts, faces, _ = uv_sphere_mesh(32, 65)
    verts, faces = verts.astype(np.float32), faces.astype(np.int32)
    with jax.disable_jit(False):
        jcam = wr.get_camera(elevation_deg=20.0, distance=2.7, fovy_deg=40.0,
                             num_views=6, near=0.1, far=10.0)[[0, 3]]
    pcam = pt.camera_from_arrays(*(_np(getattr(jcam, f)) for f in CAM_FIELDS),
                                 device="cpu")
    jmesh = wr.TexturedMesh(v_pos=jnp.asarray(verts), t_pos_idx=jnp.asarray(faces))
    return jmesh, jcam, pt.mesh_from_arrays(verts, faces, device="cpu"), pcam


_RENDER_KW = dict(render_attr=False, render_depth=True, render_normal=True)


@functools.lru_cache(maxsize=None)
def _port_render(backend):
    _, _, pmesh, pcam = _sphere_both()
    return pt.render(pmesh, pcam, 512, 512, device="cpu",
                     raster_config=pt.RasterizerConfig(backend=backend),
                     **_RENDER_KW)


@pytest.mark.parametrize("backend", ["fused_pallas", "vpu_pallas", "pallas"])
def test_render_sphere_matches_jax(reference, backend):
    """Workload 1 at its full 512² width, two of its six views: mask equal,
    positions and depth within 1e-5, normals bit for bit. ``render`` runs
    its fused branch (K2) for ``fused_pallas`` and its classic branch (K4,
    then ``interpolate``) for ``vpu_pallas`` and ``pallas``, as the JAX
    package's ``render`` routes them."""
    jmesh, jcam, _, _ = _sphere_both()
    ref = wr.render(jmesh, jcam, 512, 512,
                    raster_config=wr.RasterizerConfig(backend=backend),
                    **_RENDER_KW)
    out = _port_render(backend)
    m = _np(ref.mask)
    np.testing.assert_array_equal(_np(out.mask), m)
    assert m.sum() > 400_000
    for f, atol in (("pos", 1e-5), ("depth", 1e-5)):
        np.testing.assert_allclose(_np(getattr(out, f)), _np(getattr(ref, f)),
                                   atol=atol, rtol=0, err_msg=f)
    assert _np(out.normal).tobytes() == _np(ref.normal).tobytes()


# Against the jitted reference: each field's largest difference where both
# masks cover, and the tolerance each is held to beyond which no more than
# the flip budget of pixels may differ (None: no pixel budget). Readings on
# the CPU (tools/port_reference_spread.py): fused pos 6.77e-3, depth 8.00e-3,
# normals 1.08e-3 (3 pixels past 5e-4); classic pos 1.08e-3 (10 pixels past
# 1e-5), depth 1.46e-3, normals 1.10e-3 (3 pixels past 5e-4). The jitted
# reference differs from its own op-by-op run by as much (fused pos 3.85e-3,
# depth 6.63e-3; classic pos 1.08e-3, depth 1.46e-3). Depth is normalised
# by each view's extremes, so one moved extreme shifts every pixel.
_JITTED_MAX = {"fused_pallas": {"pos": 1e-2, "depth": 1e-2, "normal": 2e-3},
               "classic": {"pos": 2e-3, "depth": 2e-3, "normal": 2e-3}}
_JITTED_BUDGET = {"fused_pallas": {"pos": None, "depth": None, "normal": 5e-4},
                  "classic": {"pos": 1e-5, "depth": None, "normal": 5e-4}}


@pytest.mark.parametrize("backend", ["fused_pallas", "vpu_pallas", "pallas"])
def test_render_sphere_within_flip_budget_of_jitted_jax(backend):
    """The same render against the reference as users run it, jitted: masks
    within the flip budget; positions, depth and normals, where both masks
    cover, within ``_JITTED_MAX`` and, where ``_JITTED_BUDGET`` sets a
    tolerance, past it at no more than the flip budget of pixels. The clip
    transform's vertex-count-dependent rounding (module docstring) moves
    steep triangles' planes, so these bounds are far wider than the op-by-op
    test's."""
    jmesh, jcam, _, _ = _sphere_both()
    ref = wr.render(jmesh, jcam, 512, 512,
                    raster_config=wr.RasterizerConfig(backend=backend),
                    **_RENDER_KW)
    out = _port_render(backend)
    fg = int(_np(ref.mask).sum())
    assert (_np(out.mask) != _np(ref.mask)).sum() <= 1e-4 * fg
    both = _np(out.mask) & _np(ref.mask)
    kind = "fused_pallas" if backend == "fused_pallas" else "classic"
    for f in ("pos", "depth", "normal"):
        d = np.abs(_np(getattr(out, f)) - _np(getattr(ref, f)))[both]
        d = d.max(axis=-1) if d.ndim > 1 else d
        assert d.max() <= _JITTED_MAX[kind][f], (f, d.max())
        atol = _JITTED_BUDGET[kind][f]
        if atol is not None:
            assert (d > atol).sum() <= 1e-4 * fg, (f, int((d > atol).sum()))
