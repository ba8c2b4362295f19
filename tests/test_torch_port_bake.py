"""The UV texture bake of the PyTorch port against the JAX package: the
image ops, grid sampling and Poisson blending one function at a time,
then ``baking/uv.py`` module by module and ``camera_projection`` end to
end, at ``tests/test_baking.py``'s size (UV 128, 6 views at 128², the
4,096-triangle UV sphere, whose atlas takes the K1 route).

Inputs are made from seeds with numpy and handed to both packages (the
port's through ``convert.py``). Each port module gets the JAX module's own
inputs, so a difference points at one module. The JAX bake runs once, op
by op (``jax.disable_jit``), and records what its stages returned: jitted,
XLA's FMA contractions and vertex-count-dependent GEMM order move the
view renders' positions by up to 3e-2 (ROADMAP queue 3), while op by op
the two packages evaluate the same fp32 expressions."""

import functools
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu as wr
import worldrenderer_tpu.baking.projection  # noqa: F401  (sys.modules below)
from worldrenderer_tpu.baking import uv as ju
from worldrenderer_tpu.ops import image as jimg
from worldrenderer_tpu.ops import poisson as jpo
from worldrenderer_tpu.ops.grid_sample import grid_sample as j_grid_sample
from worldrenderer_tpu.ops.grid_sample import grid_sample_parts as j_grid_sample_parts
from worldrenderer_tpu.ops.rasterize import auto_fast_config as j_auto_fast_config

import worldrenderer_tpu_torch as pt
import worldrenderer_tpu_torch.ops.grid_sample  # noqa: F401  (sys.modules below)
from worldrenderer_tpu_torch.baking import projection as pproj
from worldrenderer_tpu_torch.baking import uv as pu
from worldrenderer_tpu_torch.ops import grid_sample_cuda as pgs_cuda
from worldrenderer_tpu_torch.ops import image as pimg
from worldrenderer_tpu_torch.ops import poisson as ppo
from worldrenderer_tpu_torch.utils.debug import counter_totals

from chip_smoke import synthetic_sample_inputs
from test_torch_kernel_designs import one_torch_thread  # noqa: F401  (fixture)

jproj = sys.modules["worldrenderer_tpu.baking.projection"]
# The port's `ops` re-exports a function named like the module.
pgs = sys.modules["worldrenderer_tpu_torch.ops.grid_sample"]

# The port's plain versions on one thread: beside other test processes
# their intra-op threads would wait on each other.
pytestmark = pytest.mark.usefixtures("one_torch_thread")

UV_SIZE, RES, N_VIEWS, PB_ITERS = 128, 128, 6, 40
CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _port_tuple(cls, jax_tuple):
    """A port NamedTuple from the JAX one, field by field (arrays become
    CPU tensors)."""
    return cls(*(_t(v) if isinstance(v, (jax.Array, np.ndarray)) else v
                 for v in jax_tuple))


def _close(ours, ref, atol, err_msg=""):
    np.testing.assert_allclose(_np(ours), _np(ref), atol=atol, rtol=0,
                               err_msg=err_msg)


def _meshes(n_lat, n_lon, uv_size):
    """The JAX and the port's textured UV sphere (checkerboard texture)."""
    verts, faces, uv = wr.mesh.uv_sphere_mesh(n_lat, n_lon)
    yy, xx = np.meshgrid(np.arange(uv_size), np.arange(uv_size), indexing="ij")
    checker = (((yy // 16) + (xx // 16)) % 2).astype(np.float32)
    tex = np.stack([checker, 1.0 - checker, np.full_like(checker, 0.5)], -1)
    jm = wr.TexturedMesh(
        v_pos=jnp.asarray(verts, jnp.float32),
        t_pos_idx=jnp.asarray(faces, jnp.int32),
        v_tex=jnp.asarray(uv, jnp.float32),
        t_tex_idx=jnp.asarray(faces, jnp.int32), texture=jnp.asarray(tex))
    pm = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                             texture=tex, device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def bake():
    """Both packages' scene, and the JAX bake run once op by op with its
    stages' outputs recorded: mesh, camera and the bench's config (sized
    by ``auto_fast_config`` for the atlas and the views, exact fp32
    dots)."""
    jm, pm = _meshes(33, 65, UV_SIZE)
    jc = wr.get_camera(elevation_deg=15.0, distance=3.0, fovy_deg=45.0,
                       num_views=N_VIEWS, near=0.1, far=10.0)
    pc = pt.camera_from_arrays(*(_np(getattr(jc, f)) for f in CAM_FIELDS),
                               device="cpu")
    uv_clip4 = jnp.concatenate([jm.v_tex * 2 - 1, jnp.zeros_like(jm.v_tex[:, :1]),
                                jnp.ones_like(jm.v_tex[:, :1])], -1)[None]
    jcfg = j_auto_fast_config(
        uv_clip4, jm.t_tex_idx, (UV_SIZE, UV_SIZE),
        extra_probes=[(wr.get_clip_space_position(jm.v_pos, jc.mvp_mtx),
                       jm.t_pos_idx, (RES, RES))],
    )._replace(dot_precision="highest")
    images = np.random.default_rng(3).random(
        (N_VIEWS, RES, RES, 3)).astype(np.float32)
    rec = {}

    def recording(name, fn):
        def wrapped(*args, **kw):
            rec[name] = fn(*args, **kw)
            return rec[name]
        return wrapped

    with mock.patch.object(jproj, "uv_precompute",
                           recording("pre", ju.uv_precompute)), \
            mock.patch.object(jproj, "uv_render_geometry",
                              recording("geo", ju.uv_render_geometry)), \
            jax.disable_jit():
        out = jproj.camera_projection(jnp.asarray(images), jm, cam=jc,
                                      uv_size=UV_SIZE, pb_num_iters=PB_ITERS,
                                      raster_config=jcfg)
    return dict(jm=jm, pm=pm, jc=jc, pc=pc, jcfg=jcfg,
                pcfg=pt.config_from_dict(jcfg._asdict()), images=images,
                out=out, **rec)


# ---- ops/image.py, ops/grid_sample.py, ops/poisson.py ----------------------


def test_image_ops_match_jax():
    rng = np.random.default_rng(11)
    img = rng.random((3, 21, 26)).astype(np.float32) * 50.0
    _close(pimg.sobel_grad_magnitude(img, device="cpu"),
           jimg.sobel_grad_magnitude(jnp.asarray(img)), 1e-6, "sobel")
    for k, pad in ((3, None), (5, None), (2, None), (3, 0)):
        np.testing.assert_array_equal(
            _np(pimg.max_pool2d(torch.from_numpy(img), k, pad, device="cpu")),
            _np(jimg.max_pool2d(jnp.asarray(img), k, pad)), err_msg=f"{k} {pad}")
    masks = rng.random((2, 19, 23)) > 0.6
    for k in (3, 5):
        np.testing.assert_array_equal(
            _np(pimg.batch_dilate(torch.from_numpy(masks), k, device="cpu")),
            _np(jimg.batch_dilate(jnp.asarray(masks), k)))
        np.testing.assert_array_equal(
            _np(pimg.batch_erode(torch.from_numpy(masks), k, device="cpu")),
            _np(jimg.batch_erode(jnp.asarray(masks), k)))
    images = rng.random((2, 19, 23, 3)).astype(np.float32)
    _close(pimg.batch_inpaint(images, masks, 4, device="cpu"),
           jimg.batch_inpaint(jnp.asarray(images), jnp.asarray(masks), 4), 1e-6)
    _close(pimg.inpaint(images[0], masks[0], 2, device="cpu"),
           jimg.inpaint(jnp.asarray(images[0]), jnp.asarray(masks[0]), 2), 1e-6)


def _grid_inputs(seed):
    rng = np.random.default_rng(seed)
    image = rng.random((2, 20, 24, 3)).astype(np.float32)
    # NDC beyond [-1, 1] too: the zero padding's taps
    grid = rng.uniform(-1.15, 1.15, (2, 9, 13, 2)).astype(np.float32)
    grid[0, 0, :5] = [[-1, -1], [1, 1], [0, 0], [-1 + 1 / 24, 0.5], [0.25, -1]]
    return image, grid


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_grid_sample_matches_jax(mode):
    image, grid = _grid_inputs(12)
    _close(pgs.grid_sample(image, grid, mode=mode, device="cpu"),
           j_grid_sample(jnp.asarray(image), jnp.asarray(grid), mode=mode),
           1e-6)


def test_grid_sample_parts_match_jax():
    """fp32, byte-packed and mask parts in one row gather, each equal to
    the JAX package's; the u8 part of k/255 texels equals the fp32 one."""
    image, grid = _grid_inputs(13)
    rng = np.random.default_rng(14)
    frames = rng.integers(0, 256, (2, 20, 24, 4)).astype(np.float32) / 255.0
    mask = (rng.random((2, 20, 24, 1)) > 0.3).astype(np.float32)
    parts = [(image, "none"), (frames, "u8"), (mask, "none")]
    ours = pgs.grid_sample_parts(parts, grid, device="cpu")
    ref = j_grid_sample_parts([(jnp.asarray(a), m) for a, m in parts],
                                jnp.asarray(grid))
    assert ours.shape == (2, 9, 13, 8)
    _close(ours, ref, 1e-6)
    _close(ours[..., 3:7], pgs.grid_sample(frames, grid, device="cpu"), 1e-6)


# S1's edge cases (``chip_smoke.py`` holds S1 to the plain version on them
# on the card): NaN / inf taps, NDC at +-1, x0 = -1 and W-1, far-out-of-range
# and NaN coordinates, C = 1, 3, 5, a 'u8' part beside fp32 ones, N = 1, 6.
SAMPLE_CASES = {name: (parts, grid)
                for name, parts, grid in synthetic_sample_inputs("cpu")}


def _same_values_and_zero_signs(ours, ref):
    ours, ref = _np(ours), _np(ref)
    np.testing.assert_array_equal(ours, ref)
    live = ~np.isnan(ref)
    np.testing.assert_array_equal(np.signbit(ours[live]), np.signbit(ref[live]))


@functools.lru_cache(maxsize=1)
def _jax_edges_n6():
    parts, grid = SAMPLE_CASES["edges_n6"]
    return _np(j_grid_sample_parts([(jnp.asarray(_np(a)), m) for a, m in parts],
                                   jnp.asarray(_np(grid))))


@pytest.mark.parametrize("name", ["edges_n1", "edges_n6"])
def test_grid_sample_parts_edges_match_jax(name):
    """The plain version (the CPU's route) on S1's edge inputs equals the
    JAX package's value for value, zeros' signs included. The N = 1 case is
    the first view of the N = 6 one, and views are sampled apart, so one
    JAX run (op by op, about 6 s) serves both."""
    parts, grid = SAMPLE_CASES[name]
    ours = pgs.grid_sample_parts(parts, grid, device="cpu")
    ref = _jax_edges_n6()[:grid.shape[0]]
    assert ours.shape == (*grid.shape[:3], 9)
    assert np.isnan(_np(ours)).any() and (_np(ours) == 0).any()
    _same_values_and_zero_signs(ours, ref)


def test_grid_sample_parts_cpu_and_grad_take_the_plain_path():
    """CPU tensors, and inputs autograd records, take the plain version and
    launch nothing; the gradient flows through it."""
    parts, grid = SAMPLE_CASES["edges_n1"]
    before = counter_totals().get("launch.s1", 0)
    got = pgs.grid_sample_parts(parts, grid, device="cpu")
    assert torch.equal(got.view(torch.int32),
                       pgs.grid_sample_parts_plain(parts, grid).view(torch.int32))
    image = parts[2][0].clone().requires_grad_()
    coords = (torch.rand((1, 4, 5, 2), generator=torch.Generator().manual_seed(2))
              * 1.6 - 0.8).requires_grad_()
    out = pgs.grid_sample_parts([(image, "none")], coords, device="cpu")
    out.sum().backward()
    assert image.grad.abs().sum() > 0 and coords.grad is not None
    assert counter_totals().get("launch.s1", 0) == before


def test_s1_route_by_device_and_grad():
    """S1 on CUDA unless autograd records the call; never off CUDA."""
    plain = torch.zeros(2)
    tracked = torch.zeros(2, requires_grad=True)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert pgs._takes_s1(cuda, [plain, plain])
    assert not pgs._takes_s1(cuda, [plain, tracked])
    with torch.no_grad():
        assert pgs._takes_s1(cuda, [plain, tracked])
    assert not pgs._takes_s1(cpu, [plain])


@pytest.mark.parametrize("fault", ["noncontiguous_part", "noncontiguous_grid",
                                   "float64_part", "int_grid", "grid_shape",
                                   "unknown_mode", "cpu_tensors"])
def test_s1_wrapper_rejects(fault):
    """S1's wrapper checks its inputs before it builds or launches."""
    image, grid = torch.zeros((1, 4, 5, 3)), torch.zeros((1, 2, 3, 2))
    parts, error = [(image, "none")], ValueError
    if fault == "noncontiguous_part":
        parts = [(torch.zeros((1, 5, 4, 3)).transpose(1, 2), "none")]
    elif fault == "noncontiguous_grid":
        grid = torch.zeros((1, 3, 2, 2)).transpose(1, 2)
    elif fault == "float64_part":
        parts, error = [(image.double(), "none")], TypeError
    elif fault == "int_grid":
        grid, error = grid.int(), TypeError
    elif fault == "grid_shape":
        grid = torch.zeros((1, 2, 3, 3))
    elif fault == "unknown_mode":
        parts = [(image, "u16")]
    with pytest.raises(error):
        pgs_cuda.sample_bilinear(parts, grid)


def _poisson_inputs():
    rng = np.random.default_rng(15)
    src = rng.random((40, 48, 3)).astype(np.float32)
    tgt = rng.random((40, 48, 3)).astype(np.float32)
    yy, xx = np.mgrid[:40, :48]
    mask = ((yy - 19) ** 2 / 150.0 + (xx - 25) ** 2 / 260.0) < 1.0
    return src, mask, tgt


@pytest.mark.parametrize("grad_mode", ["src", "max", "avg"])
def test_poisson_blend_matches_jax(grad_mode):
    src, mask, tgt = _poisson_inputs()
    ours = ppo.poisson_blend(src, mask, tgt, num_iters=PB_ITERS,
                             grad_mode=grad_mode, device="cpu")
    ref = jpo.poisson_blend(jnp.asarray(src), jnp.asarray(mask),
                            jnp.asarray(tgt), num_iters=PB_ITERS,
                            grad_mode=grad_mode)
    _close(ours, ref, 1e-5)
    np.testing.assert_array_equal(_np(ours)[~mask], tgt[~mask])


def test_poisson_multigrid_cropped_and_solver_match_jax():
    src, mask, tgt = _poisson_inputs()
    js, jmask, jt = jnp.asarray(src), jnp.asarray(mask), jnp.asarray(tgt)
    _close(ppo.poisson_blend_multigrid(src, mask, tgt, num_iters=PB_ITERS,
                                       levels=3, device="cpu"),
           jpo.poisson_blend_multigrid(js, jmask, jt, num_iters=PB_ITERS,
                                       levels=3), 1e-5)
    ours = ppo.poisson_blend_cropped(src, mask, tgt, num_iters=PB_ITERS,
                                     bucket=16, device="cpu")
    _close(ours, jpo.poisson_blend_cropped(js, jmask, jt, num_iters=PB_ITERS,
                                           bucket=16), 1e-5)
    np.testing.assert_array_equal(
        _np(ppo.poisson_blend_cropped(src, np.zeros_like(mask), tgt,
                                      device="cpu")), tgt)
    solver = ppo.PoissonBlendingSolver(device="cpu")
    _close(solver(src, mask, tgt, PB_ITERS, grad_mode="avg"),
           jpo.PoissonBlendingSolver()(js, jmask, jt, PB_ITERS, grad_mode="avg"),
           1e-5)


# ---- baking/uv.py ----------------------------------------------------------


def test_uv_precompute_k4_route_matches_jax():
    """Below 4,096 texture triangles the atlas is classic ``rasterize``
    (K4) and ``interpolate``; the mesh's backface cull is forced off."""
    jm, pm = _meshes(17, 33, 64)
    assert pm.t_tex_idx.shape[0] < 4096
    cfg = dict(backface_cull=-1)
    ref = ju.uv_precompute(jm, 64, 64, wr.ops.RasterizerConfig(**cfg))
    ours = pu.uv_precompute(pm, 64, 64, pt.RasterizerConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(_np(ours.uv_mask), _np(ref.uv_mask))
    assert _np(ours.uv_mask).mean() > 0.9
    _close(ours.uv_pos, ref.uv_pos, 1e-5)
    _close(ours.uv_attr, ref.uv_attr, 0.0)


def test_uv_precompute_k1_route_matches_jax(bake):
    assert bake["pm"].t_tex_idx.shape[0] >= bake["pcfg"].bin_sort_pairs_min_tris
    ours = pu.uv_precompute(bake["pm"], UV_SIZE, UV_SIZE,
                            bake["pcfg"]._replace(backface_cull=-1),
                            device="cpu")
    ref = bake["pre"]
    np.testing.assert_array_equal(_np(ours.uv_mask), _np(ref.uv_mask))
    _close(ours.uv_pos, ref.uv_pos, 1e-5)


def test_uv_render_geometry_matches_jax(bake):
    """The view-space half against the JAX package's run; the texel-space
    half (``uv_gather_geometry``) on the JAX package's own view maps."""
    ref = bake["geo"]
    pre = _port_tuple(pu.UVPrecomputeOutput, bake["pre"])
    ours = pu.uv_render_geometry(bake["pm"], bake["pc"], RES, RES, pre,
                                 compute_depth_grad=True, depth_grad_dilation=5,
                                 raster_config=bake["pcfg"], device="cpu")
    np.testing.assert_array_equal(_np(ours.view_mask), _np(ref.view_mask))
    for f, atol in (("view_position", 1e-5), ("view_depth", 1e-5),
                    ("view_normal", 5e-5), ("view_aoi_cos", 5e-5),
                    ("uv_pos_proj", 1e-5), ("uv_pos_ndc", 1e-6),
                    ("uv_aoi_cos", 5e-5)):  # normals and cosines read 2.5e-5
        _close(getattr(ours, f), getattr(ref, f), atol, f)
    for f in ("view_depth_grad", "uv_depth_grad"):  # silhouettes reach 1e2
        np.testing.assert_allclose(_np(getattr(ours, f)), _np(getattr(ref, f)),
                                   atol=1e-4, rtol=1e-5, err_msg=f)

    view = pu.UVViewGeometry(*(_t(getattr(ref, f))
                               for f in pu.UVViewGeometry._fields))
    gathered = pu.uv_gather_geometry(view, bake["pc"], pre, device="cpu")
    for f in ("uv_pos_proj", "uv_pos_error", "uv_aoi_cos", "uv_pos_ndc",
              "uv_depth_grad"):
        _close(getattr(gathered, f), getattr(ref, f), 1e-6, f)


def test_uv_render_attr_matches_jax(bake):
    """Byte-packed k/255 images with fp32 masks in one gather, and nearest
    sampling, on the JAX package's texel coordinates."""
    geo = bake["geo"]
    pgeo = _port_tuple(pu.UVRenderGeometryOutput, geo)
    rng = np.random.default_rng(16)
    frames = rng.integers(0, 256, (N_VIEWS, RES, RES, 3)).astype(np.float32) / 255.0
    masks = (rng.random((N_VIEWS, RES, RES, 3)) > 0.2).astype(np.float32)
    for kw in (dict(pack_mode="u8"), dict(grid_sample_mode="nearest")):
        ours = pu.uv_render_attr(frames, pgeo, masks=masks, device="cpu", **kw)
        ref = ju.uv_render_attr(jnp.asarray(frames), geo,
                                masks=jnp.asarray(masks), **kw)
        _close(ours.uv_attr_proj, ref.uv_attr_proj, 1e-6, str(kw))
        _close(ours.uv_mask_proj, ref.uv_mask_proj, 1e-6, str(kw))


_BLENDS = {
    "linear": (dict(pos_error_eps=2e-2, aoi_cos_thresh=0.3),
               dict(alpha=6.0), dict()),
    "softmax_first_view": (dict(pos_error_eps=2e-2, aoi_cos_thresh=0.3,
                                first_view_dominate=True, depth_grad_thresh=0.5),
                           dict(alpha=2.0, normalization="softmax"),
                           dict(do_uv_padding=False)),
    "view_weight_jacobi": (dict(pos_error_eps=2e-2, aoi_cos_thresh=0.3),
                           dict(alpha=6.0, view_weight=[1.0, 2.0, 1.0, 0.5,
                                                        1.0, 1.0]),
                           dict(poisson_blending=True, pb_num_iters=PB_ITERS,
                                pb_keep_original_border=False)),
    "multigrid": (dict(), dict(), dict(poisson_blending=True,
                                       pb_num_iters=PB_ITERS,
                                       pb_solver="multigrid",
                                       pb_grad_mode="max")),
    "cropped": (dict(), dict(), dict(poisson_blending=True,
                                     pb_num_iters=PB_ITERS,
                                     pb_solver="cropped", pad_unseen_area=True)),
}


@pytest.mark.parametrize("name", sorted(_BLENDS))
def test_uv_blend_matches_jax(bake, name):
    """Validity, weights and the blended texture on the JAX package's
    precompute, geometry and sampled images."""
    val_kw, blend_kw, kw = _BLENDS[name]
    jattr = ju.uv_render_attr(jnp.asarray(bake["images"]), bake["geo"])
    ref = ju.uv_blend(
        bake["pre"], bake["geo"], jattr,
        uv_validity_strategy=ju.SimpleUVValidityStrategy(**val_kw),
        uv_blend_weight_strategy=ju.ExponentialBlend(**{
            k: jnp.asarray(v) if k == "view_weight" else v
            for k, v in blend_kw.items()}), **kw)
    ours = pu.uv_blend(
        _port_tuple(pu.UVPrecomputeOutput, bake["pre"]),
        _port_tuple(pu.UVRenderGeometryOutput, bake["geo"]),
        _port_tuple(pu.UVRenderAttrOutput, jattr),
        uv_validity_strategy=pu.SimpleUVValidityStrategy(**val_kw),
        uv_blend_weight_strategy=pu.ExponentialBlend(**blend_kw),
        device="cpu", **kw)
    np.testing.assert_array_equal(_np(ours.uv_valid_mask), _np(ref.uv_valid_mask))
    assert _np(ours.uv_valid_mask_blend).mean() > 0.2
    _close(ours.uv_blend_weight, ref.uv_blend_weight, 1e-6, "weight")
    _close(ours.uv_attr_blend, ref.uv_attr_blend, 1e-5, "blend")


def test_random_choice_blend_on_jax_draws(bake):
    """RandomChoiceBlend's one-hot choice on the JAX key's own uniform
    draws; with a torch.Generator it picks a valid view wherever one is."""
    pre, geo = bake["pre"], bake["geo"]
    valid = ju.SimpleUVValidityStrategy(pos_error_eps=2e-2)(pre, geo, None)
    key = jax.random.PRNGKey(5)
    ref = ju.RandomChoiceBlend(key)(pre, geo, None, valid)
    weight = _t(geo.uv_aoi_cos) * _t(valid).float()
    draws = _t(jax.random.uniform(key, weight.shape))
    np.testing.assert_array_equal(
        _np(pu._random_choice_weights(weight, draws)), _np(ref))
    gen = torch.Generator().manual_seed(5)
    out = pu.RandomChoiceBlend(gen)(None, _port_tuple(pu.UVRenderGeometryOutput,
                                                      geo), None, _t(valid))
    assert torch.equal(out.sum(0), torch.ones_like(out[0]))
    picked = (out.bool() & _t(valid)).any(0)
    assert torch.equal(picked, _t(valid).any(0))


# ---- baking/projection.py ---------------------------------------------------


def test_camera_projection_matches_jax(bake):
    """End to end with the defaults (Poisson at 40 sweeps): the baked mask
    within 1e-3 of the chart's texels, the texture within 5e-4 wherever
    both bakes are valid, the cosines within 5e-5."""
    ours = pproj.camera_projection(bake["images"], bake["pm"], cam=bake["pc"],
                                   uv_size=UV_SIZE, pb_num_iters=PB_ITERS,
                                   raster_config=bake["pcfg"], device="cpu")
    ref = bake["out"]
    m, rm = _np(ours.uv_proj_mask), _np(ref.uv_proj_mask)
    chart = _np(bake["pre"].uv_mask).sum()
    assert rm.mean() > 0.2
    assert (m != rm).sum() <= 1e-3 * chart
    both = m & rm
    np.testing.assert_allclose(_np(ours.uv_proj)[both], _np(ref.uv_proj)[both],
                               atol=5e-4, rtol=0)
    _close(ours.uv_aoi_cos, ref.uv_aoi_cos, 5e-5, "aoi")  # 1.8e-5 read


def test_camera_projection_iou_rejection_and_unported_options(bake):
    """Masks that disagree with the silhouettes return None; the rendered
    masks themselves pass. device_mesh refuses warp_images (the sharded
    bake takes pre-warped views; it is held by
    tests/test_torch_port_parallel.py); warp_images without
    images_background raises (the warp itself:
    tests/test_torch_port_paint.py)."""
    kw = dict(cam=bake["pc"], uv_size=UV_SIZE, poisson_blending=False,
              raster_config=pt.RasterizerConfig(), device="cpu",
              validate_binning=False)
    bad = np.zeros((N_VIEWS, RES, RES), np.float32)
    bad[:, :8, :8] = 1.0
    assert pproj.camera_projection(bake["images"], bake["pm"], masks=bad,
                                   **kw) is None
    good = _np(bake["geo"].view_mask).astype(np.float32)
    out = pproj.CameraProjection(device="cpu")(
        bake["images"], bake["pm"], masks=good, return_dict=True, **kw)
    assert out is not None and out.uv_proj.shape == (UV_SIZE, UV_SIZE, 3)
    from worldrenderer_tpu_torch.parallel import make_device_mesh

    with pytest.raises(ValueError, match="pre-warped"):
        pproj.camera_projection(bake["images"], bake["pm"], warp_images=True,
                                images_background=0.5,
                                device_mesh=make_device_mesh(devices=["cpu"]),
                                **kw)
    with pytest.raises(ValueError, match="images_background"):
        pproj.camera_projection(bake["images"], bake["pm"], warp_images=True,
                                **kw)


def test_auto_footprint_even_count_matches_jax():
    """'auto' bounds scale by the median foreground depth; with an even
    count ``jnp.nanmedian`` averages the two middle values, which
    ``torch.nanmedian`` (the lower one) would miss."""
    rng = np.random.default_rng(17)
    depth = rng.uniform(1.0, 3.0, (3, 10, 12)).astype(np.float32)
    mask = np.zeros((3, 10, 12), bool)
    mask[0, :4, :5] = True  # 20 pixels
    mask[1, 2:8, 3:4] = True  # 6 pixels
    mask[2, :3, :3] = True  # 9 pixels, odd
    jcam = wr.get_camera(elevation_deg=15.0, distance=3.0, fovy_deg=45.0,
                         num_views=3, near=0.1, far=10.0)
    pcam = pt.camera_from_arrays(*(_np(getattr(jcam, f)) for f in CAM_FIELDS),
                                 device="cpu")
    ours = pproj._auto_footprint(pcam, torch.from_numpy(mask),
                                 torch.from_numpy(depth), 10)
    ref = jproj._auto_footprint(jcam, jnp.asarray(mask), jnp.asarray(depth), 10)
    np.testing.assert_array_equal(_np(ours), _np(ref))
    fg = torch.where(torch.from_numpy(mask), torch.from_numpy(depth), torch.nan)
    lower = torch.nanmedian(fg.reshape(3, -1), dim=1).values
    med = pproj._nanmedian_rows(fg.reshape(3, -1))
    assert (med[:2] != lower[:2]).all() and med[2] == lower[2]
