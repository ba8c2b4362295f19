"""The texture tools of the PyTorch port against the JAX package: the warp's
resize and grid, ``compute_warp_field`` and ``camera_projection``'s
``warp_images``, the segmentation hooks, the smart painter and
``utils/images.py``.

Inputs come from seeds with numpy and go to both packages (the port's
through ``convert.py``). The warp's fits follow ``tests/test_warp.py``'s
blob cases, the painter ``tests/test_smart_paint.py``'s tiny scene with a
recording inpainter, the port given the JAX package's anchor rig (no torch
generator reproduces ``jax.random``), and the hooks
``tests/test_neural_hooks.py``'s contracts."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import worldrenderer_tpu as wr
from worldrenderer_tpu.baking import seg as jseg
from worldrenderer_tpu.baking import smart_paint as jsp
from worldrenderer_tpu.baking import warp as jw
from worldrenderer_tpu.ops.rasterize import RasterizerConfig as JConfig
from worldrenderer_tpu.utils import images as jimages

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch.baking import projection as pproj
from worldrenderer_tpu_torch.baking import seg as pseg
from worldrenderer_tpu_torch.baking import smart_paint as psp
from worldrenderer_tpu_torch.baking import warp as pw
from worldrenderer_tpu_torch.utils import images as pimages

from test_torch_kernel_designs import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_cam(jc):
    return pt.camera_from_arrays(*(_np(getattr(jc, f)) for f in CAM_FIELDS),
                                 device="cpu")


# ---- the warp --------------------------------------------------------------


@pytest.mark.parametrize("n_in, res", [(512, 64), (512, 128), (48, 96), (64, 64)])
def test_resize_matches_jax(n_in, res):
    img = np.random.default_rng(n_in + res).random((2, n_in, n_in, 3)).astype(np.float32)
    ours = pw._resize(torch.from_numpy(img), res)
    assert tuple(ours.shape) == (2, res, res, 3)
    for v in range(2):
        np.testing.assert_allclose(_np(ours[v]), np.asarray(jw._resize(
            jnp.asarray(img[v]), res)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_grid", [4, 10])
def test_grid_mesh_and_pixel_coords_match_jax(n_grid):
    ours, ref = pw.construct_grid_mesh(n_grid), jw.construct_grid_mesh(n_grid)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    verts, faces, edges, movable = ours
    assert verts.shape == ((n_grid + 1) ** 2, 3) and movable.sum() == (n_grid - 1) ** 2
    assert faces.shape == (2 * n_grid ** 2, 3)
    assert len(np.unique(edges, axis=0)) == len(edges)
    v = (verts[:, :2] + 0.03 * np.random.default_rng(n_grid).normal(
        size=verts[:, :2].shape) * movable[:, None]).astype(np.float32)
    np.testing.assert_allclose(
        _np(pw._grid_pixel_coords(torch.from_numpy(v)[None], n_grid, 40)[0]),
        np.asarray(jw._grid_pixel_coords(jnp.asarray(v), n_grid, 40)),
        atol=1e-6, rtol=0)


def _blob(cx, cy, n=64):
    yy, xx = np.mgrid[0:n, 0:n] / (n - 1)
    img = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02).astype(np.float32)
    return np.repeat(img[..., None], 3, axis=-1)


WARP_CASES = {
    # test_warp.py:73, the zero-step schedule: src through the unmoved grid
    "zero_steps": (_blob(0.4, 0.6)[None], _blob(0.6, 0.4)[None],
                   dict(n_grid=6, optim_res=(32,), optim_step_per_res=0)),
    # test_warp.py:34
    "shift": (_blob(0.55, 0.5)[None], _blob(0.45, 0.5)[None],
              dict(n_grid=8, optim_res=(32, 64), optim_step_per_res=30,
                   lambda_reg=0.5)),
    # test_warp.py:48
    "no_correspondence": (_blob(0.5, 0.5)[None], np.full((1, 64, 64, 3), 0.5, np.float32),
                          dict(n_grid=6, optim_res=(32,), optim_step_per_res=40)),
    # two views fitted together, each toward its own target
    "two_views": (np.stack([_blob(0.55, 0.5), _blob(0.5, 0.45)]),
                  np.stack([_blob(0.45, 0.5), _blob(0.5, 0.55)]),
                  dict(n_grid=7, optim_res=(32, 64), optim_step_per_res=15)),
}


@pytest.fixture(scope="module")
def jax_warps():
    return {name: np.asarray(jw.compute_warp_field(src, tgt, **kw))
            for name, (src, tgt, kw) in WARP_CASES.items()}


@pytest.mark.parametrize("name", list(WARP_CASES))
def test_warp_matches_jax(jax_warps, name):
    """Within 1e-6 of the JAX package without a step, within 1e-3 after the
    fits (measured 7.5e-6 at most: Adam's steps in the two packages round
    apart)."""
    src, tgt, kw = WARP_CASES[name]
    ours = _np(pw.compute_warp_field(src, tgt, device="cpu", **kw))
    atol = 1e-6 if kw["optim_step_per_res"] == 0 else 1e-3
    np.testing.assert_allclose(ours, jax_warps[name], atol=atol, rtol=0)
    assert ours.min() >= 0.0 and ours.max() <= 1.0
    if name == "shift":
        before = float(((src - tgt) ** 2).mean())
        assert float(((ours - tgt) ** 2).mean()) < 0.5 * before


def test_warp_identity_and_extreme_lr():
    """test_warp.py:25 and :95 on the port. From a zero residual the port's
    gradient is exactly 0, so Adam never moves the grid and the result is
    the zero-step resample. (The JAX package's first step is not 0: its
    edge lengths inside the jitted scan round apart from the rest lengths
    computed outside it, and Adam scales that round-off to a full step,
    ROADMAP queue 3.) With lr 2.0 the fit diverges; the output stays
    finite."""
    img = _blob(0.5, 0.5)[None]
    out = pw.compute_warp_field(img, img, n_grid=6, optim_res=(32,),
                                optim_step_per_res=5, device="cpu")
    still = pw.compute_warp_field(img, img, n_grid=6, optim_res=(32,),
                                  optim_step_per_res=0, device="cpu")
    assert torch.equal(out, still)
    np.testing.assert_allclose(_np(out), img, atol=0.05)
    src, tgt = _blob(0.55, 0.5)[None], _blob(0.45, 0.5)[None]
    wild = pw.compute_warp_field(src, tgt, n_grid=6, optim_res=(32,),
                                 optim_step_per_res=20, lr=2.0, device="cpu")
    assert torch.isfinite(wild).all()


# ---- camera_projection(warp_images=True) and the segmentation hooks --------

RES, UV, N_VIEWS = 96, 64, 4
# 32x32 tiles cover the 96² views and the 64² atlas exactly: the plain
# tile passes scan no pixel outside them (the output is the same).
HOOK_CFG = pt.RasterizerConfig(tile_w=32)


@pytest.fixture(scope="module")
def sphere_scene():
    """test_neural_hooks.py's scene on the port: the 17x33 UV sphere with a
    checker / ramp texture, 4 views at 96² over a 0.0 background."""
    verts, faces, uv = wr.mesh.uv_sphere_mesh(17, 33)
    yy, xx = np.meshgrid(np.arange(UV), np.arange(UV), indexing="ij")
    tex = np.stack([((yy // 8 + xx // 8) % 2).astype(np.float32),
                    (xx / UV).astype(np.float32), (yy / UV).astype(np.float32)], -1)
    mesh = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                               texture=tex, device="cpu")
    cam = pt.get_camera(elevation_deg=10.0, distance=3.0, fovy_deg=45.0,
                        num_views=N_VIEWS, near=0.1, far=10.0, device="cpu")
    views = pt.render(mesh, cam, RES, RES, attr_background=0.0,
                      raster_config=HOOK_CFG, device="cpu")
    return mesh, cam, views


def test_camera_projection_warps_the_views(sphere_scene):
    """warp_images=True fits each view to a render of the mesh over
    images_background with the JAX package's fixed arguments, then bakes
    the warped views: equal to doing those steps by hand."""
    mesh, cam, views = sphere_scene
    cam = cam[:2]
    shifted = torch.roll(views.attr[:2], shifts=2, dims=2)
    kw = dict(cam=cam, uv_size=UV, poisson_blending=False, device="cpu",
              iou_rejection_threshold=None, raster_config=HOOK_CFG)
    out = pproj.camera_projection(shifted, mesh, warp_images=True,
                                  images_background=0.0, **kw)
    target = pt.render(mesh, cam, RES, RES, render_depth=False,
                       render_normal=False, attr_background=0.0,
                       raster_config=HOOK_CFG, device="cpu").attr
    warped = pw.compute_warp_field(shifted, target, n_grid=10,
                                   optim_res=(64, 128), optim_step_per_res=20,
                                   lambda_reg=2.0, device="cpu")
    assert float(((warped - target) ** 2).mean()) < float(
        ((shifted - target) ** 2).mean())
    by_hand = pproj.camera_projection(warped, mesh, **kw)
    assert torch.equal(out.uv_proj, by_hand.uv_proj)
    assert torch.equal(out.uv_proj_mask, by_hand.uv_proj_mask)
    with pytest.raises(ValueError, match="images_background"):
        pproj.camera_projection(shifted, mesh, warp_images=True, **kw)


def test_threshold_matting_matches_jax():
    rng = np.random.default_rng(4)
    images = rng.random((3, 20, 24, 4)).astype(np.float32)
    images[0, :5, :5, :3] = 0.5  # exactly the background
    images[1, :5, :5, :3] = np.float32(0.5) + np.float32(0.02)
    for kw in (dict(), dict(bg_color=(0.0, 0.0, 0.0), threshold=0.6)):
        ref = np.asarray(jseg.ThresholdMatting(**kw)(jnp.asarray(images)))
        ours = pseg.ThresholdMatting(device="cpu", **kw)(images)
        assert ours.shape == (3, 20, 24, 1) and ours.dtype == torch.float32
        np.testing.assert_array_equal(_np(ours), ref)
        np.testing.assert_array_equal(
            _np(pseg.ThresholdMatting(**kw)(torch.from_numpy(images))), ref)


class _FakeSegmenter(pseg.SegmentationModel):
    """test_neural_hooks.py's recording matte: foreground = pixels that
    differ from the 0.0 render background."""

    def __init__(self):
        self.calls = []

    def __call__(self, images):
        self.calls.append({"shape": tuple(images.shape), "dtype": images.dtype,
                           "min": float(images.min()), "max": float(images.max())})
        assert images.ndim == 4 and images.shape[-1] == 3
        return (images.abs().sum(-1) > 1e-4).float()[..., None]


class _WrongSegmenter(pseg.SegmentationModel):
    """All foreground: disagrees with the silhouettes."""

    def __call__(self, images):
        return torch.ones(images.shape[:3] + (1,))


def test_segmenter_hook_contracts(sphere_scene):
    """test_neural_hooks.py:78 and :107 through the port's
    camera_projection: the hook runs once on the (Nv, H, W, 3) float view
    batch in [0, 1]; a matte that agrees with the silhouettes bakes, one
    that disagrees trips the IoU rejection."""
    mesh, cam, views = sphere_scene
    kw = dict(remove_bg=True, iou_rejection_threshold=0.8,
              poisson_blending=False, uv_size=UV, raster_config=HOOK_CFG,
              device="cpu")
    seg = _FakeSegmenter()
    out = pproj.camera_projection(views.attr, mesh, cam, bg_remover=seg, **kw)
    assert len(seg.calls) == 1
    c = seg.calls[0]
    assert c["shape"] == (N_VIEWS, RES, RES, 3) and c["dtype"] == torch.float32
    assert 0.0 <= c["min"] and c["max"] <= 1.0 + 1e-6
    assert out is not None and out.uv_proj.shape == (UV, UV, 3)
    assert torch.isfinite(out.uv_proj).all()
    assert pproj.camera_projection(views.attr, mesh, cam,
                                   bg_remover=_WrongSegmenter(), **kw) is None


def test_rmbg_model_needs_transformers(monkeypatch, tmp_path):
    """No fallback: without ``transformers`` the constructor raises naming
    it (no weights can be downloaded, so no test builds the network)."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        pseg.RMBGModel(str(tmp_path), device="cpu")


# ---- the smart painter -----------------------------------------------------

PAINT_UV = 32
# 16x32 tiles: the plain tile passes scan fewer pixels outside the 32²
# score views than at the default 32x128 (the output is the same). Both
# packages take it.
PAINT_TILES = dict(tile_h=16, tile_w=32)


class RecordingInpainter:
    """test_smart_paint.py's fake: logs every (image, mask) and fills the
    masked pixels with a constant."""

    def __init__(self, fill=1.0, use_jax=False):
        self.fill, self.use_jax = fill, use_jax
        self.images, self.masks = [], []

    def __call__(self, image, mask):
        self.images.append(_np(image))
        self.masks.append(_np(mask))
        if self.use_jax:
            return jnp.where(mask[..., None] > 0.5, self.fill, image)
        return torch.where(mask[..., None] > 0.5, self.fill, image)


def _tiny_paint_scene():
    verts, faces, uvc = wr.mesh.uv_sphere_mesh(9, 17)
    tex = np.full((PAINT_UV, PAINT_UV, 3), 0.6, np.float32)
    hole = np.zeros((PAINT_UV, PAINT_UV), bool)
    hole[PAINT_UV // 4: 3 * PAINT_UV // 4, PAINT_UV // 4: 3 * PAINT_UV // 4] = True
    tex[hole] = 0.0
    jm = wr.TexturedMesh(
        v_pos=jnp.asarray(verts, jnp.float32), t_pos_idx=jnp.asarray(faces, jnp.int32),
        v_tex=jnp.asarray(uvc, jnp.float32), t_tex_idx=jnp.asarray(faces, jnp.int32),
        texture=jnp.asarray(tex))
    pm = pt.mesh_from_arrays(verts, faces, v_tex=uvc, t_tex_idx=faces,
                             texture=tex, device="cpu")
    return jm, pm, tex, hole


PAINT_KW = dict(min_rounds=2, max_rounds=2, max_view_score_thresh=-1.0,
                score_render_size=32, inpaint_render_size=64)


@pytest.fixture(scope="module")
def jax_paint():
    """Two rounds of the JAX painter on the tiny scene (key 3), with each
    round's 108 view scores recomputed from its own score render, as
    ``SmartPainter.__call__`` computes them."""
    jm, _, tex, hole = _tiny_paint_scene()
    scores = []
    real = jsp._view_aoi_cos

    def recording_aoi(out, cam):
        aoi = real(out, cam)
        if aoi.shape[0] == 108:
            attr0 = out.attr[..., 0]
            unc = ((attr0 < 1e-3) & (aoi > 0.1)).sum(axis=(1, 2))
            w = (((attr0 > 1e-3) & (aoi > 0.1)).astype(jnp.float32)
                 * jnp.clip(aoi - attr0 - 0.3, a_min=0.0)).sum(axis=(1, 2))
            scores.append(np.asarray((unc + w) / float(32 ** 2)))
        return aoi

    rec = RecordingInpainter(use_jax=True)
    key = jax.random.PRNGKey(3)
    mp = pytest.MonkeyPatch()
    mp.setattr(jsp, "_view_aoi_cos", recording_aoi)
    try:
        tex_out, covered = jsp.SmartPainter(JConfig(**PAINT_TILES))(
            jm, rec, jnp.asarray(tex), jnp.asarray(hole), key=key, **PAINT_KW)
    finally:
        mp.undo()
    return dict(rig=jsp._make_view_selection_cams(key), scores=scores, rec=rec,
                tex=np.asarray(tex_out), covered=np.asarray(covered))


def test_smart_painter_matches_jax(jax_paint, monkeypatch):
    """The port given the JAX package's rig: per round the same best view,
    the 108 view scores within 1e-6 (measured 0), the inpainter's images
    within 1e-4 and its masks within 1e-3 of their foreground (measured
    3.4e-6 and 0 flips); the final texture within 1e-4 where both runs
    are valid (measured 0)."""
    _, pm, tex, hole = _tiny_paint_scene()
    rig = _port_cam(jax_paint["rig"])
    monkeypatch.setattr(psp, "_make_view_selection_cams",
                        lambda generator=None, device=None: rig.to(device))
    rec = RecordingInpainter()
    painter = psp.SmartPainter(pt.RasterizerConfig(**PAINT_TILES))
    tex_out, covered = painter(pm, rec, tex, hole, device="cpu", **PAINT_KW)
    ref_rec = jax_paint["rec"]
    assert len(painter.history) == len(rec.images) == len(ref_rec.images) == 2
    for r, h in enumerate(painter.history):
        ref_scores = jax_paint["scores"][r]
        assert h["best_view"] == int(ref_scores.argmax()), f"round {r}"
        np.testing.assert_allclose(h["view_scores"], ref_scores, atol=1e-6, rtol=0)
        np.testing.assert_allclose(rec.images[r], ref_rec.images[r], atol=1e-4,
                                   rtol=0)
        fg = max(1, int((ref_rec.masks[r] > 0).sum()))
        assert (rec.masks[r] != ref_rec.masks[r]).sum() <= 1e-3 * fg
        assert rec.images[r].shape == (64, 64, 3) and rec.masks[r].shape == (64, 64)
        assert set(np.unique(rec.masks[r])) <= {0.0, 1.0}
    covered, tex_out = _np(covered), _np(tex_out)
    both = covered & jax_paint["covered"]
    assert both.sum() > 0.8 * covered.sum()
    np.testing.assert_allclose(tex_out[both], jax_paint["tex"][both], atol=1e-4,
                               rtol=0)
    assert covered[~hole].all()  # the initial validity is kept


def test_smart_painter_rig_and_loop_contract():
    """The port's own rig: 108 cameras, the 9 x 12 elevation / azimuth grid
    at distance 1.2 jittered within [-0.1, 0.1], the same generator seed
    giving the same rig; and the loop's exits: max_rounds with a threshold
    no score meets, min_rounds with one every score meets."""
    rig = psp._make_view_selection_cams(torch.Generator().manual_seed(7), "cpu")
    again = psp._make_view_selection_cams(torch.Generator().manual_seed(7), "cpu")
    other = psp._make_view_selection_cams(torch.Generator().manual_seed(8), "cpu")
    assert len(rig) == 108 and torch.equal(rig.c2w, again.c2w)
    assert not torch.equal(rig.c2w, other.c2w)
    grid = pt.get_camera(
        elevation_deg=np.repeat(np.arange(-60, 61, 15), 12).astype(np.float32),
        azimuth_deg=np.tile(np.arange(0, 360, 30), 9).astype(np.float32),
        distance=1.2, fovy_deg=40.0, device="cpu")
    jitter = rig.cam_pos - grid.cam_pos
    assert float(jitter.abs().max()) <= 0.1 + 1e-6 and float(jitter.abs().max()) > 0.05
    torch.testing.assert_close(rig.proj_mtx, grid.proj_mtx, rtol=0, atol=0)

    _, pm, tex, hole = _tiny_paint_scene()
    painter = psp.SmartPainter(pt.RasterizerConfig(**PAINT_TILES))
    kw = dict(score_render_size=16, inpaint_render_size=32, device="cpu")
    rec = RecordingInpainter()
    painter(pm, rec, tex, hole, min_rounds=0, max_rounds=2,
            max_view_score_thresh=-1.0, **kw)
    assert len(rec.images) == len(painter.history) == 2
    rec = RecordingInpainter()
    out, _ = painter(pm, rec, tex, hole, min_rounds=1, max_rounds=8,
                     max_view_score_thresh=1e9, **kw)
    assert len(rec.images) == 1 and torch.isfinite(out).all()


def test_default_inpaint_func_matches_jax():
    rng = np.random.default_rng(6)
    image = rng.random((40, 48, 3)).astype(np.float32)
    mask = np.zeros((40, 48), np.float32)
    mask[10:30, 5:40] = 1.0
    ours = psp.default_inpaint_func(torch.from_numpy(image), torch.from_numpy(mask))
    ref = jsp.default_inpaint_func(jnp.asarray(image), jnp.asarray(mask))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=1e-6, rtol=0)


# ---- utils/images.py -------------------------------------------------------


def test_image_helpers_match_jax():
    rng = np.random.default_rng(8)
    f = rng.random((6, 10, 3)).astype(np.float32) * 1.2 - 0.1
    for data, kw in ((f, {}), (f > 0.5, {}), (f.transpose(2, 0, 1), dict(format="CHW"))):
        ours = pimages.tensor_to_image(torch.from_numpy(np.ascontiguousarray(data)), **kw)
        np.testing.assert_array_equal(np.asarray(ours),
                                      np.asarray(jimages.tensor_to_image(data, **kw)))
    batch = pimages.tensor_to_image(torch.from_numpy(f[None].repeat(2, 0)), batched=True)
    assert len(batch) == 2 and batch[0].size == (10, 6)
    img = Image.fromarray((f.clip(0, 1) * 255).astype(np.uint8))
    ours = pimages.image_to_tensor(img)
    assert isinstance(ours, torch.Tensor) and ours.dtype == torch.float32
    np.testing.assert_array_equal(_np(ours), np.asarray(jimages.image_to_tensor(img)))
    both = pimages.image_to_tensor([img, img], return_type="np")
    assert isinstance(both, np.ndarray) and both.shape == (2, 6, 10, 3)
    with pytest.raises(ValueError, match="'pt', 'np'"):
        pimages.image_to_tensor(img, return_type="jnp")
    for n in range(1, 50):
        assert pimages.largest_factor_near_sqrt(n) == jimages.largest_factor_near_sqrt(n)
    tiles = [Image.fromarray((rng.random((6, 10, 3)) * 255).astype(np.uint8))
             for _ in range(6)]
    for kw in (dict(), dict(rows=3), dict(cols=6), dict(rows=2, resize=8)):
        np.testing.assert_array_equal(np.asarray(pimages.make_image_grid(tiles, **kw)),
                                      np.asarray(jimages.make_image_grid(tiles, **kw)))
    with pytest.raises(ValueError):
        pimages.make_image_grid(tiles, rows=4)
    stamp = pimages.get_current_timestamp()
    assert len(stamp) == 14 and stamp.isdigit()
