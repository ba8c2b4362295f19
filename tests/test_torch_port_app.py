"""The application of the PyTorch port against the JAX package on the CPU:
the cubic upscale, the normal rebake, ``load_packed_images``,
``TexturePipeline`` (CUSTOM cameras; the ORTHO rig with base colour, ORM,
normal and the Poisson reprojection passes; the view-inpaint wiring),
``project_and_render`` (raster exact and fast, keyframes with a next
camera path, the host atlas, the debug image, a .blend through the stub
Blender, its error), ``project_view_to_view``, the CLI's arguments and the
export CLIs.

The JAX references run op by op (``jax.disable_jit()``), once per module:
the port reproduces the JAX package's op-by-op rounding, and the JAX
package's jitted bake differs from its own op-by-op bake by more than the
limits here (XLA's fusion reorders the fp32 arithmetic; measured 5e-3 in
the view G-buffer's positions of this scene, and 20 validity flips).
Inputs are made with numpy from seeds, or rendered by the port. Scenes:
``tests/test_project_render_cli.py``'s (4 frames at 96², uv 96) for the
application, ``tests/test_pipeline_e2e.py``'s (96², uv 96) for the
pipeline. Torch and numpy run on one thread.

The limits are the ``[app]`` phase's of ``chip_smoke.py`` wherever these
scenes' readings meet them, and else the readings, named here. The view
G-buffer's positions and depth are bit for bit the JAX package's op-by-op
ones (``test_render_positions_match_jax_bit_for_bit``: the inverse MVP in
LAPACK's rounding order, the unprojection in the CPU einsum's), so no
texel sits on the other side of a validity threshold. So:

- the written mask flips at most 1e-4 of the foreground (0 read); depth
  within 1 LSB of 16 bits and normal frames within 1 LSB at every pixel
  outside the flips;
- rgb frames within 1 LSB at all but FRAME_SHARE (0) of the foreground
  outside the flips (0 read);
- validity flips at most MAX_BAKE_FLIPS (0) texels a bake (0 read in the
  CUSTOM bake; the ORTHO rig's three bakes are held to 1e-4 of their
  valid texels, 0 read);
- baked textures within 1e-4 (1 LSB once written) at all but TEX_SHARE
  (0) of texels (0 read; the ORTHO rig's at 1e-4, 0 read).

The JAX package's Poisson solve runs jitted inside its op-by-op bakes:
bit for bit its op-by-op result (its adds keep their order; its products
are by 0, 1, 0.25 and 4, all exact), in less time."""

import io
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

import worldrenderer_tpu as wr
from worldrenderer_tpu.baking import uv as ju
from worldrenderer_tpu.mesh import uv_sphere_mesh
from worldrenderer_tpu.pipelines import export_tools as jex
from worldrenderer_tpu.pipelines import pipeline_view as jpv
from worldrenderer_tpu.pipelines import project_render as jpr
from worldrenderer_tpu.pipelines import texture_pipeline as jtp
from worldrenderer_tpu.scene import blender as jblender
from worldrenderer_tpu.scene.camera_json import save_camera_json
from worldrenderer_tpu.scene.gltf import save_glb

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch.pipelines import export_tools as pex
from worldrenderer_tpu_torch.pipelines import pipeline_view as ppv
from worldrenderer_tpu_torch.pipelines import project_render as ppr
from worldrenderer_tpu_torch.pipelines import texture_pipeline as ptp
from worldrenderer_tpu_torch.scene import blender as pblender
from worldrenderer_tpu_torch.scene.gltf import parse_glb

from stub_bpy import Scene, make_stub_bpy

RES = 96
UV = 96
# The ORTHO rig's views and atlas.
ORTHO_RES = 48
ORTHO_UV = 96
N_FRAMES = 4
CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")
SEQS = ("rgb", "mask", "normal", "depth")
# The limits that the readings set (module docstring).
FRAME_SHARE = 0
MAX_BAKE_FLIPS = 0
TEX_SHARE = 0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_cam(jc):
    return pt.camera_from_arrays(*(_np(getattr(jc, f)) for f in CAM_FIELDS),
                                 device="cpu")


def _sphere_glb(path, tex):
    verts, faces, uv = uv_sphere_mesh(17, 33)
    save_glb(path, verts.astype(np.float32), faces.astype(np.uint32), uv=uv,
             texture=tex)


def _orbit(az=None, elevation=10.0):
    if az is None:
        return wr.get_camera(elevation_deg=elevation, distance=3.0, fovy_deg=45.0,
                             num_views=N_FRAMES, near=0.1, far=10.0)
    n = len(az)
    return wr.get_camera(
        elevation_deg=np.full(n, elevation, np.float32),
        distance=np.full(n, 3.0, np.float32), fovy_deg=np.full(n, 45.0, np.float32),
        azimuth_deg=np.asarray(az, np.float32), near=0.1, far=10.0)


def _write_video(path, frames):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (frames.shape[2], frames.shape[1]))
    for f in frames:
        writer.write(cv2.cvtColor((np.clip(f, 0, 1) * 255).astype(np.uint8),
                                  cv2.COLOR_RGB2BGR))
    writer.release()


def _footage(glb, cam):
    """The scene's own views, rendered by the port on the CPU."""
    mesh = pt.load_mesh(str(glb), flip_uv=True, device="cpu")
    return _np(pt.render(mesh, _port_cam(cam), RES, RES, render_depth=False,
                         render_normal=False, attr_background=0.0,
                         device="cpu").attr)


# ---- scenes ------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory):
    """test_project_render_cli.py's scenes: the 64² checker sphere with its
    4-frame orbit and footage, and the grey sphere on an 8-frame path that
    steps 1 and 89 degrees in turn (test_project_render_cli.py:103's jump,
    repeated: keyframes {0, 2, 4, 6}, so the JAX reference's bake shares
    the exact run's shapes), seeded footage and a next camera path."""
    tmp = tmp_path_factory.mktemp("cli")
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    tex = np.stack([((yy // 8 + xx // 8) % 2).astype(np.float32), xx / 64.0,
                    yy / 64.0], axis=-1).astype(np.float32)
    glb = tmp / "scene.glb"
    _sphere_glb(glb, tex)
    cam = _orbit()
    save_camera_json(tmp / "camera.json", np.asarray(cam.c2w), 45.0, 0.1, 10.0)
    frames = _footage(glb, cam)
    _write_video(tmp / "footage.mp4", frames)

    grey = tmp / "grey.glb"
    _sphere_glb(grey, np.full((64, 64, 3), 0.5, np.float32))
    az = np.array([0.0, 1.0, 90.0, 91.0, 180.0, 181.0, 270.0, 271.0], np.float32)
    kcam = _orbit(az)
    save_camera_json(tmp / "key_camera.json", np.asarray(kcam.c2w), 45.0, 0.1, 10.0)
    ncam = _orbit(az + 5.0, elevation=30.0)
    save_camera_json(tmp / "next_camera.json", np.asarray(ncam.c2w), 45.0, 0.1, 10.0)
    _write_video(tmp / "key_footage.mp4",
                 np.random.default_rng(13).random((8, RES, RES, 3)))
    return dict(dir=tmp, glb=glb, frames=frames, grey=grey)


def _app_kwargs(scene, **kw):
    base = dict(mesh_path=scene["glb"], video_path=scene["dir"] / "footage.mp4",
                height=RES, width=RES, uv_size=UV, max_frames=N_FRAMES,
                camera_json=scene["dir"] / "camera.json", uv_unwarp=False)
    return {**base, **kw}


def _key_kwargs(scene):
    d = scene["dir"]
    return dict(mesh_path=scene["grey"], video_path=d / "key_footage.mp4",
                height=RES, width=RES, uv_size=UV, max_frames=8,
                camera_json=d / "key_camera.json",
                next_camera_json=d / "next_camera.json", keyframe_selection=True,
                keyframe_t_position=0.5, keyframe_t_rotation=0.5, uv_unwarp=False)


@pytest.fixture(scope="module")
def jax_app(cli_scene, tmp_path_factory):
    """The JAX package's project_and_render, op by op: raster exact with
    the debug image, and the keyframe + next-camera case."""
    out = tmp_path_factory.mktemp("jax_app")
    with jax.disable_jit():
        jpr.project_and_render(output_dir=out / "exact",
                               **_app_kwargs(cli_scene, debug=True))
        jpr.project_and_render(output_dir=out / "keys", **_key_kwargs(cli_scene))
    return out


def _read(path):
    return np.asarray(Image.open(path)).astype(np.int64)


def _glb_images(path):
    scene = parse_glb(path)
    return [np.asarray(Image.open(io.BytesIO(scene.image_bytes(i)[0])))
            .astype(np.int64) for i in range(len(scene.gltf.get("images", [])))]


def _near(got, want, lsb, share, what):
    """``got`` within ``lsb`` of ``want`` at all but ``share`` of the
    entries of the mask ``where`` (every entry when None)."""
    bad = (np.abs(got - want) > lsb).reshape(got.shape[0], got.shape[1], -1).any(-1)
    assert bad.sum() <= share * bad.size, (what, int(bad.sum()), bad.size,
                                           int(np.abs(got - want).max()))


def _hold_frames(ours, ref, n):
    """The four written sequences against the reference's, with the limits
    of the module docstring."""
    for seq in SEQS:
        names = sorted(p.name for p in (ours / seq).glob("*.png"))
        assert names == [f"{seq}_{i:05d}.png" for i in range(n)], seq
        assert names == sorted(p.name for p in (ref / seq).glob("*.png")), seq
    for i in range(n):
        def read(root, seq):
            return _read(root / seq / f"{seq}_{i:05d}.png")

        assert np.abs(read(ours, "depth") - read(ref, "depth")).max() <= 1
        m, rm = read(ours, "mask") > 0, read(ref, "mask") > 0
        fg = int(rm.sum())
        assert fg > 1000 and (m != rm).sum() <= 1e-4 * fg
        for seq in ("rgb", "normal"):
            bad = (np.abs(read(ours, seq) - read(ref, seq)) > 1).any(-1) & (m == rm)
            assert bad.sum() <= (FRAME_SHARE if seq == "rgb" else 0) * fg, (
                seq, i, int(bad.sum()))


# ---- _default_upscale --------------------------------------------------------


@pytest.mark.parametrize("n", [48, 37])
def test_default_upscale_matches_jax_cubic(n):
    """``_default_upscale`` within 1e-6 of ``jax.image.resize(method=
    "cubic")`` (jitted), clipped, at n -> 2n, 3 channels."""
    img = np.random.default_rng(n).random((2, n, n, 3)).astype(np.float32)
    ref = np.asarray(jtp._default_upscale(jnp.asarray(img), 2))
    ours = ptp._default_upscale(torch.from_numpy(img), 2)
    assert tuple(ours.shape) == (2, 2 * n, 2 * n, 3)
    np.testing.assert_allclose(_np(ours), ref, atol=1e-6, rtol=0)


# ---- the normal rebake ---------------------------------------------------------


@pytest.fixture(scope="module")
def e2e_scene(tmp_path_factory):
    """test_pipeline_e2e.py's scene: the sphere with a 96² texture (checker,
    x and y ramps), its 4-view orbit, camera JSON and rendered views; and
    for the ORTHO rig six seeded views of each modality, written as a PNG
    directory (base colour), one packed strip (ORM) and a comma list
    (normal map)."""
    tmp = tmp_path_factory.mktemp("e2e")
    yy, xx = np.meshgrid(np.arange(UV), np.arange(UV), indexing="ij")
    tex = np.stack([((yy // 12 + xx // 12) % 2).astype(np.float32),
                    (xx / UV).astype(np.float32), (yy / UV).astype(np.float32)],
                   axis=-1)
    glb = tmp / "scene.glb"
    _sphere_glb(glb, tex)
    cam = _orbit()
    save_camera_json(tmp / "camera.json", np.asarray(cam.c2w), 45.0, 0.1, 10.0)
    views = _footage(glb, cam)

    rng = np.random.default_rng(21)
    base, orm, nrm = (rng.random((6, ORTHO_RES, ORTHO_RES, 3)) for _ in range(3))
    u8 = lambda a: (np.clip(a, 0, 1) * 255 + 0.5).astype(np.uint8)  # noqa: E731
    (tmp / "base").mkdir()
    for i, v in enumerate(base):
        Image.fromarray(u8(v)).save(tmp / "base" / f"view_{i}.png")
    Image.fromarray(u8(np.concatenate(list(orm), axis=1))).save(tmp / "orm.png")
    nrm_files = [tmp / f"normal_{i}.png" for i in range(6)]
    for f, v in zip(nrm_files, nrm):
        Image.fromarray(u8(v)).save(f)
    return dict(dir=tmp, glb=glb, cam=cam, views=views,
                normal_list=",".join(map(str, nrm_files)))


@pytest.mark.parametrize("n_views", [6, 8])
def test_rebake_normal_matches_jax(n_views):
    """The rebake of a seeded normal map on a UV sphere (9 x 17, half-extent
    0.5), with the six-view rig's tangents and with eight views (views 7-8
    take the +x tangent): bit for bit the JAX package's ``_rebake_normal``
    run op by op, 0.5 where no pixel is covered. The JAX package's render
    is given the port's normals and tangents (the render is held by
    test_torch_port_attr.py), so the frames' crosses, normalizations and
    3x3 products are what is compared."""
    verts, faces, uv = uv_sphere_mesh(9, 17)
    pm = pt.mesh_from_arrays(0.5 * verts, faces, v_tex=uv, t_tex_idx=faces,
                             device="cpu")
    jc = wr.get_orthogonal_camera(
        elevation_deg=np.linspace(-60, 60, n_views).astype(np.float32),
        distance=np.full(n_views, 1.0, np.float32), left=-0.55, right=0.55,
        bottom=-0.55, top=0.55,
        azimuth_deg=np.linspace(0, 315, n_views).astype(np.float32))
    mod = np.random.default_rng(n_views).random((n_views, 48, 48, 3)).astype(np.float32)
    renders = []
    real_render = ptp.render

    def keep_render(*a, **k):
        renders.append(real_render(*a, **k))
        return renders[-1]

    with mock.patch.object(ptp, "render", keep_render):
        ours = ptp.TexturePipeline(device="cpu")._rebake_normal(
            torch.from_numpy(mod), pm, _port_cam(jc))
    (out,) = renders
    given = mock.Mock(normal=jnp.asarray(_np(out.normal)),
                      tangent=jnp.asarray(_np(out.tangent)))
    with jax.disable_jit(), \
            mock.patch.object(jtp, "render", return_value=given) as render:
        ref = np.asarray(jtp.TexturePipeline()._rebake_normal(
            jnp.asarray(mod), None, jc))
    assert render.call_args.kwargs["render_tangent"] is True
    covered = _np(out.mask)
    assert covered.mean() > 0.3 and tuple(ours.shape) == mod.shape
    assert _np(ours).tobytes() == ref.tobytes(), int((_np(ours) != ref).sum())
    np.testing.assert_allclose(_np(ours)[~covered], 0.5, atol=0)


# ---- load_packed_images --------------------------------------------------------


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """PNGs in every colour mode Pillow writes (RGB, RGBA, L, LA, P, and a
    1-bit image), a JPEG, and a strip of three views."""
    tmp = tmp_path_factory.mktemp("packed")
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (20, 24, 3), np.uint8)
    imgs = {
        "a_rgb.png": Image.fromarray(rgb),
        "b_rgba.png": Image.fromarray(rng.integers(0, 256, (20, 24, 4), np.uint8)),
        "c_grey.png": Image.fromarray(rng.integers(0, 256, (20, 24), np.uint8)),
        "d_la.png": Image.fromarray(rng.integers(0, 256, (20, 24, 2), np.uint8)),
        "e_palette.png": Image.fromarray(rgb).quantize(7),
        "f_bits.png": Image.fromarray(rng.integers(0, 2, (20, 24), np.uint8)
                                      * 255).convert("1"),
    }
    (tmp / "dir").mkdir()
    for name, im in imgs.items():
        im.save(tmp / "dir" / name)
    (tmp / "dir" / "notes.txt").write_text("not an image")
    Image.fromarray(rgb).save(tmp / "photo.jpg", quality=90)
    Image.fromarray(rng.integers(0, 256, (16, 3 * 10, 3), np.uint8)).save(
        tmp / "strip.png")
    return tmp


def _packed_cases(d):
    files = sorted(str(p) for p in (d / "dir").glob("*.png"))
    return [(str(d / "dir"), None), (str(d / "dir"), 6),
            (",".join(files[:3]) + ", ", 3), (str(d / "strip.png"), 3),
            (str(d / "strip.png"), None), (str(d / "photo.jpg"), 1)]


def test_load_packed_images_matches_jax(packed):
    """Directories (non-image files skipped), comma lists, single images
    split into strips, and every PNG colour mode: equal to the JAX
    package's Pillow-read arrays; a JPEG goes through Pillow."""
    jp, pp = jtp.TexturePipeline(), ptp.TexturePipeline(device="cpu")
    assert pp.load_packed_images(None) is None
    for path, n in _packed_cases(packed):
        ref = jp.load_packed_images(path, num_views=n)
        ours = pp.load_packed_images(path, num_views=n)
        assert ours.dtype == np.float32 and ours.shape == ref.shape, path
        np.testing.assert_array_equal(ours, ref)


def test_load_packed_images_errors(packed, monkeypatch):
    """The JAX package's ValueErrors for a strip that does not split and a
    count that does not match; without Pillow, a JPEG raises an
    ImportError that names it and a PNG still loads."""
    pp = ptp.TexturePipeline(device="cpu")
    for path, n, msg in ((str(packed / "strip.png"), 4, "not divisible"),
                         (str(packed / "dir"), 5, "expected 5")):
        with pytest.raises(ValueError, match=msg):
            jtp.TexturePipeline().load_packed_images(path, num_views=n)
        with pytest.raises(ValueError, match=msg):
            pp.load_packed_images(path, num_views=n)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        pp.load_packed_images(str(packed / "photo.jpg"))
    assert pp.load_packed_images(str(packed / "strip.png"), 3).shape == (3, 16, 10, 3)


# ---- TexturePipeline -----------------------------------------------------------


def _recording(module, store):
    real = module.camera_projection

    def rec(*a, **k):
        out = real(*a, **k)
        store.append(out)
        return out
    return mock.patch.object(module, "camera_projection", rec)


def _custom_kwargs(scene):
    return dict(mesh_path=str(scene["glb"]), save_name="e2e", uv_size=UV,
                camera_projection_type="CUSTOM",
                custom_camera_json=str(scene["dir"] / "camera.json"))


@pytest.fixture(scope="module")
def jax_custom(e2e_scene, tmp_path_factory):
    """The JAX package's TexturePipeline, op by op, with CUSTOM cameras and
    the rendered views as rgb_tensor, its camera_projection's output
    recorded."""
    rec = []
    with jax.disable_jit(), _recording(jtp, rec):
        out = jtp.TexturePipeline()(
            save_dir=str(tmp_path_factory.mktemp("custom")),
            rgb_tensor=jnp.asarray(e2e_scene["views"]), **_custom_kwargs(e2e_scene))
    return out, rec


def test_texture_pipeline_custom_cameras_matches_jax(e2e_scene, jax_custom, tmp_path):
    """CUSTOM cameras from the JSON, the views as rgb_tensor, uv inpainting:
    the bake's validity flips at most MAX_BAKE_FLIPS texel, uv_proj_rgb within 1e-4 and the shaded GLB's texture within 1
    LSB at all but TEX_SHARE of texels, the UVs equal."""
    rec = []
    with _recording(ptp, rec):
        out = ptp.TexturePipeline(device="cpu")(
            save_dir=str(tmp_path), rgb_tensor=torch.from_numpy(e2e_scene["views"]),
            **_custom_kwargs(e2e_scene))
    ref, (jrec,) = jax_custom
    (ours,) = rec
    m, rm = _np(ours.uv_proj_mask), _np(jrec.uv_proj_mask)
    assert rm.sum() > 1000 and (m != rm).sum() <= MAX_BAKE_FLIPS, int(
        (m != rm).sum())
    _near(_np(out.uv_proj_rgb), np.asarray(ref.uv_proj_rgb), 1e-4, TEX_SHARE, "rgb")
    np.testing.assert_array_equal(_np(out.mesh_v_tex), np.asarray(ref.mesh_v_tex))
    np.testing.assert_array_equal(_np(out.mesh_t_tex_idx),
                                  np.asarray(ref.mesh_t_tex_idx))
    assert out.pbr_model_save_path is None and Path(
        out.shaded_model_save_path).name == "e2e_shaded.glb"
    (got,), (want,) = (_glb_images(out.shaded_model_save_path),
                       _glb_images(ref.shaded_model_save_path))
    _near(got, want, 1, TEX_SHARE, "shaded GLB")


class _Stop(Exception):
    pass


def test_render_positions_match_jax_bit_for_bit(e2e_scene, tmp_path):
    """render()'s unprojected world positions on the CUSTOM bake's mesh and
    cameras (as TexturePipeline hands them to camera_projection, at 96²,
    with the bake's depth normalization) equal the JAX package's op-by-op
    render bit for bit, and so do the mask and depth: the inverse MVP is
    taken in the JAX package's LAPACK rounding order
    (transforms.inverse_f32) and the unprojection and view transform in its
    einsum's (pairwise sums of rounded products), where torch.linalg.inv
    and an FMA chain rounded apart and flipped a validity texel of this
    bake. The normals too: the face normals' cross product and the norms
    round as the JAX package's op-by-op ``jnp.cross`` and
    ``jnp.linalg.norm`` (``transforms.cross``, ``transforms.norm``)."""
    from worldrenderer_tpu.render import SimpleNormalization as JNorm

    from worldrenderer_tpu_torch.render import SimpleNormalization

    given = []

    def stop(images, mesh, cam, **kw):
        given.append((mesh, cam))
        raise _Stop

    with mock.patch.object(ptp, "camera_projection", stop), pytest.raises(_Stop):
        ptp.TexturePipeline(device="cpu")(
            save_dir=str(tmp_path), rgb_tensor=torch.from_numpy(e2e_scene["views"]),
            **_custom_kwargs(e2e_scene))
    ((mesh, cam),) = given
    kw = dict(render_attr=False, render_depth=True, render_normal=True)
    ours = pt.render(mesh, cam, RES, RES, device="cpu",
                     depth_normalization_strategy=SimpleNormalization(
                         scale=1.0, offset=0.0, clamp=False, bg_value=1e2), **kw)
    jmesh = wr.TexturedMesh(v_pos=jnp.asarray(_np(mesh.v_pos)),
                            t_pos_idx=jnp.asarray(_np(mesh.t_pos_idx)))
    jcam = wr.Camera(**{f: jnp.asarray(_np(getattr(cam, f))) for f in CAM_FIELDS})
    with jax.disable_jit():
        ref = wr.render(jmesh, jcam, RES, RES,
                        depth_normalization_strategy=JNorm(
                            scale=1.0, offset=0.0, clamp=False, bg_value=1e2), **kw)
    assert int(np.asarray(ref.mask).sum()) > 5000
    for name in ("mask", "pos", "depth", "normal"):
        a, b = _np(getattr(ours, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), (name, int((a != b).sum()))


def _host(x):
    return None if x is None else _np(x)


def _jitted(fn):
    """``fn`` run with jit on inside a ``jax.disable_jit()`` block."""
    def call(*a, **k):
        with jax.disable_jit(False):
            return fn(*a, **k)
    return call


def _fake_projection(calls, out_type, wrap):
    """A stand-in for camera_projection that records each call (the images
    and camera on the host, the mesh's texture, the keyword arguments) and
    returns, in numpy, a texture from the views' mean colours and the
    mesh's texture, and a fixed mask: the pipeline's own steps (modality
    loop, upscale, rebake, flat-normal fill, Poisson pass order, ORM
    channel, GLB export) are what the packages are compared on.
    camera_projection itself is held by test_torch_port_bake.py."""
    def fake(images, mesh, cam, **kw):
        imgs = _host(images)
        uv = kw["uv_size"]
        yy, xx = np.mgrid[:uv, :uv]
        tex = imgs.mean(axis=(1, 2))[(yy * 7 + xx * 3) % imgs.shape[0]]
        if mesh.texture is not None and tuple(mesh.texture.shape) == tex.shape:
            tex = 0.5 * tex + 0.5 * _host(mesh.texture)
        mask = (yy + 2 * xx) % 5 != 0
        calls.append(dict(images=imgs, mvp=_host(cam.mvp_mtx),
                          texture=_host(mesh.texture),
                          kw={k: _host(v) if hasattr(v, "shape") else v
                              for k, v in kw.items() if k != "device"}))
        return out_type(wrap(tex.astype(np.float32)), wrap(mask), None, None)
    return fake


def _ortho_kwargs(scene):
    return dict(mesh_path=str(scene["glb"]), save_name="ortho", uv_size=ORTHO_UV,
                keep_original_transform=False,
                base_color_path=str(scene["dir"] / "base"),
                base_color_process_config=ptp.ModProcessConfig(view_upscale=True),
                orm_path=str(scene["dir"] / "orm.png"),
                normal_path=scene["normal_list"], poisson_reprojection=True)


def test_texture_pipeline_ortho_pbr_matches_jax(e2e_scene, tmp_path):
    """The ORTHO six-view rig over the rescaled mesh with base colour (a
    directory, upscaled x2 through the cubic resize), ORM (a packed strip)
    and a normal map (a comma list, rebaked), and the two Poisson
    reprojection passes, through a recorded stand-in projection
    (_fake_projection) and, on the JAX package's side, the port's render
    for the rebake: every call's images within 1e-6 (the rebaked normals
    too: 1.2e-7 read), cameras within 1e-6 and arguments equal; ORM's channel 0
    set to 1; the PBR GLB's geometry equal and its three textures within 1
    LSB. (The bake and the passes themselves are held against the JAX
    package's in test_texture_pipeline_ortho_poisson_reprojection_matches_jax.)"""
    from worldrenderer_tpu.baking.projection import CameraProjectionOutput as JOut

    from worldrenderer_tpu_torch.baking.projection import CameraProjectionOutput

    ours, ref, renders = [], [], []
    real_render = ptp.render

    def keep_render(*a, **k):
        renders.append(real_render(*a, **k))
        return renders[-1]

    with mock.patch.object(ptp, "camera_projection",
                           _fake_projection(ours, CameraProjectionOutput,
                                            torch.from_numpy)), \
            mock.patch.object(ptp, "render", keep_render):
        out = ptp.TexturePipeline(device="cpu")(
            save_dir=str(tmp_path / "port"), **_ortho_kwargs(e2e_scene))
    (given,) = renders
    given = mock.Mock(normal=jnp.asarray(_np(given.normal)),
                      tangent=jnp.asarray(_np(given.tangent)))
    kw = _ortho_kwargs(e2e_scene)
    kw["base_color_process_config"] = jtp.ModProcessConfig(view_upscale=True)
    with mock.patch.object(jtp, "camera_projection", _fake_projection(ref, JOut, jnp.asarray)), \
            mock.patch.object(jtp, "render", return_value=given):
        jout = jtp.TexturePipeline()(save_dir=str(tmp_path / "jax"), **kw)
    # base colour and ORM: a bake, then the passes over views 4-5 and 0-3;
    # the normal map: a bake
    assert len(ours) == len(ref) == 7
    up, n = (2 * ORTHO_RES,) * 2, (ORTHO_RES,) * 2
    assert [c["images"].shape[:3] for c in ours] == [
        (6, *up), (2, *up), (4, *up), (6, *n), (2, *n), (4, *n), (6, *n)]
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o["images"], r["images"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(o["mvp"], r["mvp"], atol=1e-6, rtol=0)
        if r["texture"] is None:
            assert o["texture"] is None
        else:
            np.testing.assert_allclose(o["texture"], r["texture"], atol=1e-6)
        assert o["kw"].keys() == r["kw"].keys()
        for k, v in r["kw"].items():
            np.testing.assert_array_equal(o["kw"][k], v, err_msg=k)
    assert out.shaded_model_save_path is None and out.uv_proj_rgb is None
    ours_glb, ref_glb = (pt.scene.load_glb(p) for p in (out.pbr_model_save_path,
                                                         jout.pbr_model_save_path))
    for k in ("vertices", "faces", "uv"):
        np.testing.assert_array_equal(ours_glb[k], ref_glb[k])
    got, want = _glb_images(out.pbr_model_save_path), _glb_images(
        jout.pbr_model_save_path)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1
    assert (got[1][..., 0] == 255).all()


def test_texture_pipeline_ortho_poisson_reprojection_matches_jax(e2e_scene, tmp_path):
    """The real ORTHO bake and both Poisson reprojection passes (views 4-5,
    then 0-3; from_scratch=False on the baked texture,
    pb_keep_original_border=True), base colour only (six seeded views at
    48²), uv 96, against the JAX package's run op by op, at the
    ``[texpipe]`` phase's limits: each of
    the three camera_projection outputs' validity flips at most 1e-4 of
    the reference's valid texels and its texture within 1e-4 at all but
    1e-4 of texels, and the PBR GLB's texture within 1 LSB (0 read in
    each)."""
    kw = dict(mesh_path=str(e2e_scene["glb"]), save_name="poisson", uv_size=ORTHO_UV,
              keep_original_transform=False,
              base_color_path=str(e2e_scene["dir"] / "base"),
              poisson_reprojection=True)
    ours, ref = [], []
    with _recording(ptp, ours):
        out = ptp.TexturePipeline(device="cpu")(save_dir=str(tmp_path / "port"), **kw)
    with jax.disable_jit(), _recording(jtp, ref), mock.patch.object(
            ju, "poisson_blend", _jitted(ju.poisson_blend)):
        jout = jtp.TexturePipeline()(save_dir=str(tmp_path / "jax"), **kw)
    assert len(ours) == len(ref) == 3
    for i, (o, r) in enumerate(zip(ours, ref)):
        m, rm = _np(o.uv_proj_mask), np.asarray(r.uv_proj_mask)
        assert rm.sum() > 100 and (m != rm).sum() <= 1e-4 * rm.sum(), (
            i, int((m != rm).sum()))
        _near(_np(o.uv_proj), np.asarray(r.uv_proj), 1e-4, 1e-4, f"bake {i}")
    (got,), (want,) = (_glb_images(out.pbr_model_save_path),
                       _glb_images(jout.pbr_model_save_path))
    _near(got, want, 1, 0, "PBR GLB")


def test_texture_pipeline_view_inpaint_wiring(e2e_scene, tmp_path):
    """inpaint_mode="view" hands the bake to the smart painter with the
    config's values and the pipeline's device, and the painter's texture
    is what the pipeline keeps. (The painter itself is held by
    test_torch_port_paint.py.)"""
    from worldrenderer_tpu_torch.baking.projection import CameraProjectionOutput

    calls, bakes = [], []

    def painter(mesh, inpaint_func, uv_proj, hole, **kw):
        calls.append((inpaint_func, hole, kw))
        return uv_proj * 0 + 0.25, ~hole

    tp = ptp.TexturePipeline(device="cpu")
    tp.smart_painter = painter
    cfg = ptp.ModProcessConfig(inpaint_mode="view",
                               view_inpaint_max_view_score_thresh=0.05,
                               view_inpaint_min_rounds=2, view_inpaint_max_rounds=3,
                               view_inpaint_uv_padding_end=False)
    with mock.patch.object(ptp, "camera_projection",
                           _fake_projection(bakes, CameraProjectionOutput,
                                            torch.from_numpy)):
        out = tp(save_dir=str(tmp_path), rgb_tensor=torch.from_numpy(
            e2e_scene["views"]), rgb_process_config=cfg, **_custom_kwargs(e2e_scene))
    (func, hole, kw), = calls
    assert func is tp.inpainter is ptp.default_inpaint_func
    yy, xx = np.mgrid[:UV, :UV]
    np.testing.assert_array_equal(_np(hole), (yy + 2 * xx) % 5 == 0)
    assert kw == dict(max_view_score_thresh=0.05, min_rounds=2, max_rounds=3,
                      uv_padding_end=False, saver=None, mod_name="rgb",
                      device=torch.device("cpu"))
    assert bakes[0]["kw"]["from_scratch"] is True
    assert bool((out.uv_proj_rgb == 0.25).all())


# ---- project_and_render --------------------------------------------------------


def test_project_and_render_matches_jax(cli_scene, jax_app, tmp_path):
    """The CLI's main path (raster "exact") on test_project_render_cli.py's
    scene, against the JAX package's run (op by op) with the limits of the
    module docstring: the four frame sequences, the debug uv_proj.png and
    the shaded GLB's texture; and the re-render's median error to the
    footage inside the mask below test_project_render_cli.py's 0.1."""
    out = tmp_path / "out"
    ppr.project_and_render(output_dir=out, device="cpu",
                           **_app_kwargs(cli_scene, debug=True))
    ref = jax_app / "exact"
    _hold_frames(out, ref, N_FRAMES)
    _near(_read(out / "debug" / "uv_proj.png"), _read(ref / "debug" / "uv_proj.png"),
          1, TEX_SHARE, "uv_proj.png")
    (got,), (want,) = (_glb_images(out / "projected_shaded.glb"),
                       _glb_images(ref / "projected_shaded.glb"))
    _near(got, want, 1, TEX_SHARE, "shaded GLB")
    for i in range(N_FRAMES):
        rgb = _read(out / "rgb" / f"rgb_{i:05d}.png") / 255.0
        mask = _read(out / "mask" / f"mask_{i:05d}.png") > 0
        assert np.median(np.abs(rgb - cli_scene["frames"][i])[mask]) < 0.1


def _hold_geometry(ours, ref):
    """A run without footage writes depth and normal frames only; they are
    the geometry of the reference's run: depth within 1 LSB, normals
    within 1 LSB at every pixel."""
    assert not (ours / "rgb").exists() and not (ours / "mask").exists()
    for i in range(N_FRAMES):
        for seq in ("depth", "normal"):
            name = f"{seq}/{seq}_{i:05d}.png"
            _near(_read(ours / name), _read(ref / name), 1, 0, name)


def test_project_and_render_fast_matches_jax(cli_scene, jax_app, tmp_path):
    """raster="fast" (auto_fast_config's budgets for these cameras), without
    footage: the re-render only, its depth and normal frames held to the
    JAX package's raster="exact" run (the budgets are validated lossless,
    so fast renders what exact renders)."""
    out = tmp_path / "out"
    ppr.project_and_render(output_dir=out, device="cpu",
                           **_app_kwargs(cli_scene, video_path=None, raster="fast"))
    _hold_geometry(out, jax_app / "exact")


def test_project_and_render_keyframes_next_camera_matches_jax(cli_scene, jax_app,
                                                             tmp_path):
    """Keyframe selection ({0, 2, 4, 6} of 8 frames) with the re-render
    along the next camera path's first 4 cameras: four frames of each
    sequence, held to the JAX package's (op by op)."""
    out = tmp_path / "out"
    ppr.project_and_render(output_dir=out, device="cpu", **_key_kwargs(cli_scene))
    _hold_frames(out, jax_app / "keys", 4)


def test_project_and_render_host_atlas(cli_scene, tmp_path):
    """uv_unwarp=True: the shaded GLB is re-atlased by the host's mesh
    processor before the bake (the _unwarp GLB beside the input), and the
    re-render still reproduces the footage inside the mask (median error
    below 0.1, test_project_render_cli.py's limit)."""
    glb = tmp_path / "scene.glb"
    glb.write_bytes(cli_scene["glb"].read_bytes())
    out = tmp_path / "out"
    ppr.project_and_render(output_dir=out, device="cpu",
                           **_app_kwargs(cli_scene, mesh_path=glb, uv_unwarp=True))
    assert (tmp_path / "scene_unwarp.glb").exists()
    for seq in SEQS:
        assert len(list((out / seq).glob("*.png"))) == N_FRAMES
    for i in range(N_FRAMES):
        rgb = _read(out / "rgb" / f"rgb_{i:05d}.png") / 255.0
        mask = _read(out / "mask" / f"mask_{i:05d}.png") > 0
        assert mask.mean() > 0.2
        assert np.median(np.abs(rgb - cli_scene["frames"][i])[mask]) < 0.1


def _fake_blender(monkeypatch, module, scene):
    """subprocess.run of the bridge ``module`` execs the generated script
    against the stub bpy (tests/test_blender_bridge.py's pattern)."""
    bpy, mathutils = make_stub_bpy(scene)
    real_run = subprocess.run

    def run(cmd, *args, **kwargs):
        if not (isinstance(cmd, list) and cmd and "blender" in str(cmd[0])):
            return real_run(cmd, *args, **kwargs)
        assert cmd[1] == "-b", cmd
        if "--python-expr" in cmd:
            src = cmd[cmd.index("--python-expr") + 1]
        else:
            src = Path(cmd[cmd.index("--python") + 1]).read_text()
        monkeypatch.setitem(sys.modules, "bpy", bpy)
        monkeypatch.setitem(sys.modules, "mathutils", mathutils)
        exec(compile(src, "<blender-script>", "exec"), {"__name__": "__main__"})

    monkeypatch.setattr(module.subprocess, "run", run)
    return bpy


def _stub_scene():
    c2w = np.asarray(_orbit().c2w, np.float64)
    return Scene({f + 1: c2w[f].tolist() for f in range(N_FRAMES)}, fov_deg=45.0,
                 clip=(0.1, 10.0))


def test_project_and_render_blend_input(cli_scene, jax_app, tmp_path, monkeypatch):
    """A .blend input through the stub Blender, without footage: the camera
    path exported into the output directory (camera.json), the GLB beside
    the .blend kept (skip if it exists), and the depth and normal frames
    held to the JAX package's run from the GLB and its camera JSON."""
    blend = tmp_path / "scene.blend"
    blend.write_bytes(b"stub")
    (tmp_path / "scene.glb").write_bytes(cli_scene["glb"].read_bytes())
    bpy = _fake_blender(monkeypatch, pblender, _stub_scene())
    out = tmp_path / "out"
    ppr.project_and_render(output_dir=out, device="cpu", **_app_kwargs(
        cli_scene, mesh_path=blend, camera_json=None, video_path=None))
    assert bpy.calls == [] and (out / "camera.json").exists()
    _hold_geometry(out, jax_app / "exact")


def test_project_and_render_needs_camera_json(cli_scene, tmp_path):
    """A non-.blend input without a camera JSON raises the JAX package's
    ValueError, in both packages."""
    kw = _app_kwargs(cli_scene, camera_json=None)
    for par, extra in ((jpr.project_and_render, {}),
                       (ppr.project_and_render, {"device": "cpu"})):
        with pytest.raises(ValueError, match="requires camera_json"):
            par(output_dir=tmp_path / "out", **kw, **extra)


def test_auto_near_far_matches_jax(cli_scene):
    """``_auto_near_far`` (whose result the JAX package's
    project_and_render discards; the port's does not call it) equals the
    JAX package's on the scene's mesh and camera path, and both return the
    given near / far for a mesh without vertices."""
    from types import SimpleNamespace

    jm = wr.load_mesh(str(cli_scene["glb"]))
    pm = pt.load_mesh(str(cli_scene["glb"]), device="cpu")
    cam = _orbit()
    ours = ppr._auto_near_far(pm, _port_cam(cam), 0.1, 10.0)
    assert ours == jpr._auto_near_far(jm, cam, 0.1, 10.0)
    assert 0.1 < ours[0] < ours[1] < 10.0
    assert ppr._auto_near_far(SimpleNamespace(v_pos=torch.zeros((0, 3))),
                              _port_cam(cam), 0.5, 7.0) == (0.5, 7.0)
    assert jpr._auto_near_far(SimpleNamespace(v_pos=jnp.zeros((0, 3))),
                              cam, 0.5, 7.0) == (0.5, 7.0)


def test_parse_args_match_jax():
    """The CLI's arguments and defaults are the JAX package's, plus
    ``--device`` (default cuda)."""
    argv = ["--blend-path", "scene.glb"]
    ours, ref = vars(ppr.parse_args(argv)), vars(jpr.parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == ref
    argv += ["--raster", "fast", "--pos-error-eps", "auto", "--keyframes",
             "--max-frames", "3"]
    ours = vars(ppr.parse_args(argv + ["--device", "cpu"]))
    assert ours.pop("device") == "cpu" and ours == vars(jpr.parse_args(argv))


def test_main_passes_the_device(cli_scene, tmp_path):
    """main() runs project_and_render with the parsed arguments and
    ``--device``."""
    with mock.patch.object(ppr, "project_and_render") as par:
        ppr.main(["--blend-path", "s.glb", "--pos-error-eps", "auto",
                  "--frame-step", "0", "--device", "cpu"])
    kw = par.call_args.kwargs
    assert kw["device"] == "cpu" and kw["pos_error_eps"] == "auto"
    assert kw["frame_step"] == 1 and kw["uv_unwarp"] is True


# ---- pipeline_view and the export CLIs -----------------------------------------


def test_project_view_to_view_matches_jax(cli_scene, tmp_path):
    """Frame 0 projected and rendered from camera 1 (90 degrees on, so much
    of view 1 was not seen): the masked L1 error within 1e-4 relative of
    the JAX package's (op by op), and the three written images within 1
    LSB at every pixel."""
    errs = {}
    for name, fn, extra in (("jax", jpv.project_view_to_view, {}),
                            ("port", ppv.project_view_to_view, {"device": "cpu"})):
        out = tmp_path / name
        out.mkdir()
        (out / "camera.json").write_bytes((cli_scene["dir"] / "camera.json").read_bytes())
        with jax.disable_jit():
            errs[name] = fn(cli_scene["glb"], cli_scene["dir"] / "footage.mp4", out,
                            uv_size=UV, **extra)
    assert errs["port"] is not None and errs["port"] > 0
    np.testing.assert_allclose(errs["port"], errs["jax"], rtol=1e-4)
    for what in ("source", "reprojected", "target"):
        _near(_read(tmp_path / "port" / f"{what}_00000.png"),
              _read(tmp_path / "jax" / f"{what}_00000.png"), 1, 0, what)


def test_export_tools_match_jax(cli_scene, tmp_path, monkeypatch):
    """export_camera_main through the stub Blender writes the JAX package's
    JSON; export_frames_main writes the JAX package's frame files."""
    scene = _stub_scene()
    for name, bridge, cli in (("jax", jblender, jex), ("port", pblender, pex)):
        _fake_blender(monkeypatch, bridge, scene)
        cli.export_camera_main(["--blend-path", "scene.blend", "--camera-json",
                                str(tmp_path / name / "camera.json")])
        cli.export_frames_main(["--video-path", str(cli_scene["dir"] / "footage.mp4"),
                                "--output-dir", str(tmp_path / name / "frames"),
                                "--frame-offset", "1"])
    assert (tmp_path / "port" / "camera.json").read_text() == (
        tmp_path / "jax" / "camera.json").read_text()
    names = sorted(p.name for p in (tmp_path / "jax" / "frames").iterdir())
    assert names == [f"frame_{i:05d}.png" for i in range(N_FRAMES - 1)]
    assert names == sorted(p.name for p in (tmp_path / "port" / "frames").iterdir())
    for n in names:
        np.testing.assert_array_equal(_read(tmp_path / "port" / "frames" / n),
                                      _read(tmp_path / "jax" / "frames" / n))
