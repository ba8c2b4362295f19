"""The scene bridges of the PyTorch port against the JAX package on the CPU,
and the public-API forms that the port shares with it: ``ops.rasterize``
the function, ``scene`` at the top level, ``TexturedMesh.uv_size``,
``edge0_pad_block``'s arguments and ``ops.tensor.__all__``; the Blender
scripts (character for character, and exec'd against ``tests/stub_bpy.py``
as ``tests/test_blender_bridge.py`` does), keyframes, video reading and the
frame writers (through the port's own PNG codec, 16-bit depth included),
and ``SaverMixin`` with tensors.

Everything here is host code: the JAX package's functions are numpy or
Pillow (no JAX op runs), so the comparisons are exact unless a docstring
states otherwise. Inputs are made with numpy from seeds; torch and numpy
run on one thread."""

import ast
import io
import json
import struct
import subprocess
import sys
import warnings
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

import worldrenderer_tpu as wr
import worldrenderer_tpu.ops.tensor  # noqa: F401  (sys.modules below)
from worldrenderer_tpu import pipelines as jpipelines
from worldrenderer_tpu import scene as jscene
from worldrenderer_tpu.scene import blender as jblender
from worldrenderer_tpu.scene import blender_depth as jdepth
from worldrenderer_tpu.scene import keyframe as jkey
from worldrenderer_tpu.scene import video as jvideo
from worldrenderer_tpu.utils import saving as jsaving

import worldrenderer_tpu_torch as pt
import worldrenderer_tpu_torch.ops.tensor  # noqa: F401  (sys.modules below)
from worldrenderer_tpu_torch import ops as pops
from worldrenderer_tpu_torch import pipelines as ppipelines
from worldrenderer_tpu_torch import scene as pscene
from worldrenderer_tpu_torch import utils as putils
from worldrenderer_tpu_torch.ops import gbuffer as pgbuffer
from worldrenderer_tpu_torch.scene import blender as pblender
from worldrenderer_tpu_torch.scene import blender_depth as pdepth
from worldrenderer_tpu_torch.scene import gltf as pgltf
from worldrenderer_tpu_torch.scene import keyframe as pkey
from worldrenderer_tpu_torch.scene import video as pvideo
from worldrenderer_tpu_torch.utils import saving as psaving

from stub_bpy import Matrix, Scene, Vector, _Object, make_stub_bpy

jt = sys.modules["worldrenderer_tpu.ops.tensor"]
ptensor = sys.modules["worldrenderer_tpu_torch.ops.tensor"]
PORT = Path(pt.__file__).resolve().parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


# ---- the public-API forms shared with the JAX package ----------------------


def test_ops_rasterize_is_the_function():
    """``ops.rasterize`` is the function, as in the JAX package, and ``ops``
    exports the G-buffer's class and entry point."""
    from worldrenderer_tpu_torch.ops import rasterize

    assert callable(rasterize) and rasterize is pt.rasterize
    assert callable(wr.ops.rasterize)
    assert pops.GBufferOutput is pgbuffer.GBufferOutput is pt.GBufferOutput
    assert pops.rasterize_gbuffer is pgbuffer.rasterize_gbuffer
    assert {"rasterize", "GBufferOutput", "rasterize_gbuffer"} <= set(pops.__all__)
    assert set(wr.ops.__all__) <= set(pops.__all__)


def test_scene_at_the_top_level():
    assert pt.scene is pscene and "scene" in pt.__all__
    assert wr.scene is jscene


@pytest.mark.parametrize("size", [None, 16, 40])
def test_textured_mesh_uv_size(size):
    """None without a texture, else the texture's height: the JAX
    package's property."""
    verts = np.random.default_rng(3).random((4, 3)).astype(np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    tex = None if size is None else np.zeros((size, size + 3, 3), np.float32)
    jm = wr.TexturedMesh(v_pos=verts, t_pos_idx=faces, texture=tex)
    pm = pt.mesh_from_arrays(verts, faces, texture=tex, device="cpu")
    assert pm.uv_size == jm.uv_size == size


@pytest.mark.parametrize("r, pad", [(4, 94), (1, 3)])
def test_edge0_pad_block_takes_the_reference_arguments(r, pad):
    """``edge0_pad_block(r, pad, dtype, neg)``, positionally, equals the
    JAX package's block; ``ops.tensor.__all__`` is the JAX package's."""
    ours = ptensor.edge0_pad_block(r, pad, torch.float32, -3.0e38)
    ref = np.asarray(jt.edge0_pad_block(r, pad, np.float32, -3.0e38))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (3, r, pad)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ptensor.__all__ == jt.__all__
    assert ptensor.edge0_pad_block(1, 2, torch.float64, -1.0).dtype == torch.float64


def test_exports_match_the_jax_package():
    """``scene`` exports every name of the JAX package's ``scene.__all__``
    (and the port's ``parse_glb``, ``load_ply``), ``pipelines`` its
    ``__all__``, and ``utils`` ``SaverMixin``."""
    assert set(jscene.__all__) | {"parse_glb", "load_ply"} == set(pscene.__all__)
    assert ppipelines.__all__ == jpipelines.__all__
    for mod in (pscene, ppipelines):
        for name in mod.__all__:
            assert getattr(mod, name) is not None
    assert putils.SaverMixin is psaving.SaverMixin and "SaverMixin" in putils.__all__


def test_no_image_library_at_module_level():
    """No module of the port imports Pillow or OpenCV at module level: the
    card's machine has neither."""
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("PIL", "cv2", "imageio",
                                                  "matplotlib"), (path, name)


def test_cameras_from_a_camera_path_equal_the_jax_package(tmp_path):
    """A camera path (seeded rotations, translations and scales) read by
    ``load_camera_from_json``: every field of the port's cameras equals
    the JAX package's, op by op, bit for bit (``affine_inverse`` takes the
    translation column as the CPU's fp32 FMA chain; a torch einsum was 1
    ulp apart in 190 of 816 elements)."""
    rng = np.random.default_rng(8)
    c2w = np.zeros((40, 4, 4))
    c2w[:, :3] = rng.normal(size=(40, 3, 4)) * rng.uniform(0.5, 3.0, (40, 1, 1))
    c2w[:, 3, 3] = 1.0
    jscene.save_camera_json(tmp_path / "cams.json", c2w, 42.0, 0.2, 30.0)
    with jax.disable_jit():
        jc, jnear, jfar = jscene.load_camera_from_json(tmp_path / "cams.json", 96, 128)
    pc, near, far = pscene.load_camera_from_json(tmp_path / "cams.json", 96, 128,
                                                 device="cpu")
    assert (near, far) == (jnear, jfar)
    for f in ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos"):
        np.testing.assert_array_equal(getattr(pc, f).numpy(),
                                      np.asarray(getattr(jc, f)), f)


# ---- the Blender bridge ------------------------------------------------------


def test_blender_scripts_equal_the_jax_package():
    assert pblender._CAMERA_EXPORT_SCRIPT == jblender._CAMERA_EXPORT_SCRIPT
    assert pdepth.DEPTH_EXPORT_SCRIPT == jdepth.DEPTH_EXPORT_SCRIPT


def _fake_blender_run(monkeypatch, scene, modules):
    """subprocess.run of the bridge modules execs the generated script or
    expression with the stub bpy installed."""
    bpy, mathutils = make_stub_bpy(scene)
    real_run = subprocess.run
    cmds = []

    def run(cmd, *args, **kwargs):
        if not (isinstance(cmd, list) and cmd and "blender" in str(cmd[0])):
            return real_run(cmd, *args, **kwargs)
        assert cmd[1] == "-b" and kwargs.get("check") is True, cmd
        cmds.append(cmd)
        if "--python-expr" in cmd:
            src = cmd[cmd.index("--python-expr") + 1]
        else:
            src = Path(cmd[cmd.index("--python") + 1]).read_text()
        monkeypatch.setitem(sys.modules, "bpy", bpy)
        monkeypatch.setitem(sys.modules, "mathutils", mathutils)
        exec(compile(src, "<blender-script>", "exec"), {"__name__": "__main__"})

    for module in modules:
        monkeypatch.setattr(module.subprocess, "run", run)
    return bpy, cmds


def _orbit_scene(n_frames=5, fov=40.0, clip=(0.25, 60.0), meshes=()):
    cam = wr.get_camera(elevation_deg=[20.0] * n_frames, distance=[3.0] * n_frames,
                        fovy_deg=[fov] * n_frames,
                        azimuth_deg=list(np.linspace(0, 300, n_frames)))
    c2w = np.asarray(cam.c2w, np.float64)
    path = {f + 1: c2w[f].tolist() for f in range(n_frames)}
    return Scene(path, fov_deg=fov, clip=clip, mesh_objects=meshes), c2w


def test_camera_export_roundtrips_through_the_port_loader(monkeypatch, tmp_path):
    """The camera script run against the stub writes the JAX package's
    JSON byte for byte and script file; the port's loader reads it back."""
    scene, c2w = _orbit_scene()
    _, cmds = _fake_blender_run(monkeypatch, scene, (jblender, pblender))
    for name, mod in (("jax", jblender), ("port", pblender)):
        mod.export_camera_json("scene.blend", tmp_path / name / "camera_path.json",
                               "/opt/blender/blender")
    (jcmd, pcmd) = cmds
    assert pcmd[:3] == jcmd[:3] == ["/opt/blender/blender", "-b", "scene.blend"]
    assert (tmp_path / "port" / "camera_path.json").read_text() == (
        tmp_path / "jax" / "camera_path.json").read_text()
    jscript = (tmp_path / "jax" / "_export_camera_tmp.py").read_text()
    pscript = (tmp_path / "port" / "_export_camera_tmp.py").read_text()
    assert pscript == jscript.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    data = json.loads((tmp_path / "port" / "camera_path.json").read_text())
    assert [d["frame"] for d in data] == [1, 2, 3, 4, 5]
    cam, near, far = pscene.load_camera_from_json(
        tmp_path / "port" / "camera_path.json", 128, 128, device="cpu")
    np.testing.assert_allclose(cam.c2w.numpy(), c2w, atol=1e-5)
    assert (near, far) == (0.25, 60.0)


def test_glb_export_expression_and_skip(monkeypatch, tmp_path):
    """The GLB export expression is the JAX package's, and an existing GLB
    is not exported again."""
    scene, _ = _orbit_scene(2)
    bpy, cmds = _fake_blender_run(monkeypatch, scene, (jblender, pblender))
    for name, mod in (("jax", jblender), ("port", pblender)):
        mod.export_blend_to_glb("scene.blend", tmp_path / name / "scene.glb")
    assert bpy.calls == [
        ("export_scene.gltf", {"filepath": str(tmp_path / n / "scene.glb"),
                               "export_format": "GLB"}) for n in ("jax", "port")]
    assert cmds[1][-1] == cmds[0][-1].replace(str(tmp_path / "jax"),
                                              str(tmp_path / "port"))
    pblender.export_blend_to_glb("scene.blend", tmp_path / "port" / "scene.glb")
    assert len(bpy.calls) == 2


def _cube_at(x):
    return _Object("MESH", Matrix([[1, 0, 0, x], [0, 1, 0, 0], [0, 0, 1, 0],
                                   [0, 0, 0, 1]]),
                   bound_box=[Vector((a, b, c)) for a in (0, 1) for b in (0, 1)
                              for c in (0, 1)])


@pytest.mark.parametrize("meshes", [(4.0,), ()])
def test_depth_script_node_graph_and_range(monkeypatch, tmp_path, meshes):
    """The depth script against the stub: the compositor graph (RLayers'
    Depth -> MapValue -> Composite), 16-bit grey PNG settings, one render
    per frame, and the range from the objects' boxes with 5% padding, or
    the camera's clip range without a mesh; the same as the JAX
    package's script gives."""
    states = {}
    for name, mod in (("jax", jdepth), ("port", pdepth)):
        path = {f: np.eye(4).tolist() for f in (1, 2, 3)}
        scene = Scene(path, fov_deg=40.0, clip=(0.5, 20.0),
                      mesh_objects=[_cube_at(x) for x in meshes])
        _fake_blender_run(monkeypatch, scene, (mod,))
        mod.export_depth_frames("scene.blend", tmp_path / name)
        mv = scene.node_tree.nodes[1]
        states[name] = (
            [n.type for n in scene.node_tree.nodes], list(scene.node_tree.links),
            mv.offset, mv.size, mv.min, mv.max, mv.use_min, mv.use_max,
            vars(scene.render.image_settings), scene.render.engine,
            scene.cycles.samples,
            sorted(p.name for p in (tmp_path / name).glob("*.png")))
    assert states["port"] == states["jax"]
    types, links, offset, size = states["port"][:4]
    assert types == ["CompositorNodeRLayers", "CompositorNodeMapValue",
                     "CompositorNodeComposite"]
    assert links == [
        ("CompositorNodeRLayers", "Depth", "CompositorNodeMapValue", 0),
        ("CompositorNodeMapValue", 0, "CompositorNodeComposite", "Image")]
    if meshes:
        min_d, max_d = 4.0, np.sqrt(27.0)
        pad = (max_d - min_d) * 0.05
        lo, hi = min_d - pad, max_d + pad
    else:
        lo, hi = 0.5, 20.0
    np.testing.assert_allclose(size[0], 1.0 / (hi - lo), rtol=1e-6)
    np.testing.assert_allclose(offset[0], -lo / (hi - lo), rtol=1e-6)
    assert states["port"][8]["color_depth"] == "16"
    assert states["port"][-1] == ["0001.png", "0002.png", "0003.png"]


# ---- keyframes ---------------------------------------------------------------


def _trajectory(seed, n=40):
    """Camera matrices with random small and large steps in position and
    rotation (a few with scale, as Blender's exports may have)."""
    rng = np.random.default_rng(seed)
    data = []
    pos = np.zeros(3)
    rot = np.eye(3)
    for i in range(n):
        pos = pos + rng.normal(0, rng.choice([0.02, 0.3]), 3)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.choice([0.01, 0.3, 0.8])
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        rot = (np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k) @ rot
        mw = np.eye(4)
        mw[:3, :3] = rot * (1.0 + 0.1 * (i % 7 == 0))
        mw[:3, 3] = pos
        data.append({"frame": i + 1, "matrix_world": mw.tolist()})
    return data


def _jump_trajectory():
    """test_project_render_cli.py:103's path: azimuths 0, 1, 120, 121."""
    cam = wr.get_camera(elevation_deg=np.full(4, 10.0, np.float32),
                        distance=np.full(4, 3.0, np.float32),
                        fovy_deg=np.full(4, 45.0, np.float32),
                        azimuth_deg=np.array([0.0, 1.0, 120.0, 121.0], np.float32))
    return [{"matrix_world": np.asarray(m, np.float64).tolist()}
            for m in np.asarray(cam.c2w)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thresholds", [(0.5, 0.1), (0.2, 0.5), (0.05, 0.02)])
def test_keyframes_match_jax(seed, thresholds, tmp_path):
    """extract_keyframes and get_keyframes (first num_views frames of a
    JSON) equal the JAX package's lists; save_keyframes writes its bytes."""
    data = _trajectory(seed)
    ours = pkey.extract_keyframes(data, *thresholds)
    assert ours == jkey.extract_keyframes(data, *thresholds) and ours[0] == 0
    path = tmp_path / "cams.json"
    path.write_text(json.dumps(data))
    ours = pkey.get_keyframes(path, 25, *thresholds)
    assert ours == jkey.get_keyframes(path, 25, *thresholds)
    pkey.save_keyframes(tmp_path / "p.json", ours)
    jkey.save_keyframes(tmp_path / "j.json", ours)
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_keyframes_on_the_jump():
    data = _jump_trajectory()
    assert pkey.extract_keyframes(data, 0.5, 0.5) == jkey.extract_keyframes(
        data, 0.5, 0.5) == [0, 2]


# ---- video -------------------------------------------------------------------


N_VIDEO = 7


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A 7-frame mp4 of seeded frames (cv2's mp4v)."""
    cv2 = pytest.importorskip("cv2")
    path = tmp_path_factory.mktemp("video") / "clip.mp4"
    rng = np.random.default_rng(11)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (40, 24))
    for _ in range(N_VIDEO):
        writer.write(rng.integers(0, 256, (24, 40, 3), np.uint8))
    writer.release()
    return path


@pytest.mark.parametrize("offset, step, max_frames", [
    (0, 1, -1), (-1, 1, -1), (2, 1, -1), (-3, 2, -1), (0, 3, -1), (0, 1, 3),
    (1, 2, 2), (0, 1, 0)])
def test_load_frames_matches_jax(video, offset, step, max_frames):
    """Offset gating, frame_step and max_frames select the JAX package's
    frames, with equal values."""
    ours = pvideo.load_frames(video, offset, step, max_frames)
    ref = jvideo.load_frames(video, offset, step, max_frames)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_load_frames_errors(video, monkeypatch, tmp_path):
    """An offset past the end keeps nothing, and an unreadable file fails,
    as in the JAX package; without OpenCV, reading video raises an
    ImportError that names it."""
    for fn in (jvideo.load_frames, pvideo.load_frames):
        with pytest.raises(RuntimeError, match="No frames"):
            fn(video, N_VIDEO, 1, -1)
        with pytest.raises(RuntimeError, match="Failed to open"):
            fn(tmp_path / "missing.mp4")
    monkeypatch.setitem(sys.modules, "cv2", None)
    for fn in (lambda: pvideo.load_frames(video),
               lambda: pvideo.export_frames(video, tmp_path / "x")):
        with pytest.raises(ImportError, match="OpenCV"):
            fn()


@pytest.mark.parametrize("offset", [0, 2, -3])
def test_export_frames_matches_jax(video, tmp_path, offset):
    for name, fn in (("jax", jvideo.export_frames), ("port", pvideo.export_frames)):
        fn(video, tmp_path / name, frame_offset=offset)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names and names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


def _frames(kind, seed=5):
    rng = np.random.default_rng(seed)
    shape = (3, 9, 13)
    if kind == "float":  # values beyond [0, 1] and at the 1/255 steps
        x = rng.uniform(-0.2, 1.2, shape + (3,)).astype(np.float32)
        x[0, 0, :4, 0] = np.array([3, 254, 255, 127], np.float32) / 255.0
        return x
    if kind == "float64_grey":
        return rng.random(shape)
    if kind == "bool":
        return rng.random(shape) > 0.5
    if kind == "uint8_rgba":
        return rng.integers(0, 256, shape + (4,), np.uint8)
    return rng.integers(0, 256, shape + (3,), np.uint8)


@pytest.mark.parametrize("kind", ["float", "float64_grey", "bool", "uint8_rgba",
                                  "uint8"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_save_frames_matches_jax(tmp_path, kind, as_tensor):
    """8-bit frames through the port's PNG encoder: decoded with Pillow,
    equal pixel for pixel (and in mode) to the JAX package's Pillow-written
    files; a tensor writes what its array writes."""
    frames = _frames(kind)
    jvideo.save_frames(frames, tmp_path / "jax", "f")
    pvideo.save_frames(torch.from_numpy(frames) if as_tensor else frames,
                       tmp_path / "port", "f")
    names = [f"f_{i:05d}.png" for i in range(3)]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for n in names:
        ours, ref = Image.open(tmp_path / "port" / n), Image.open(tmp_path / "jax" / n)
        assert ours.mode == ref.mode
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_save_depth_frames_16bit_matches_jax(tmp_path, dtype, as_tensor):
    """16-bit grey depth through the port's encoder: the JAX package's
    uint16 values (round half up of clip(d, 0, 1) * 65535 in the frame's
    precision), read back by Pillow and by the port's decoder."""
    rng = np.random.default_rng(9)
    depth = rng.uniform(-0.1, 1.1, (2, 11, 7)).astype(dtype)
    depth[0, 0, :3] = [0.5 / 65535, 1.5 / 65535, 1.0]
    with warnings.catch_warnings():  # Pillow 12 deprecates mode="I;16"
        warnings.simplefilter("ignore", DeprecationWarning)
        jvideo.save_depth_frames_16bit(depth, tmp_path / "jax", "d")
    pvideo.save_depth_frames_16bit(torch.from_numpy(depth) if as_tensor else depth,
                                   tmp_path / "port", "d")
    for i in range(2):
        data = (tmp_path / "port" / f"d_{i:05d}.png").read_bytes()
        ref = np.asarray(Image.open(tmp_path / "jax" / f"d_{i:05d}.png"))
        ours = np.asarray(Image.open(io.BytesIO(data)))
        assert ref.dtype == ours.dtype == np.uint16
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(pgltf._decode_png16(data), ref)
        expect = (np.clip(depth[i], 0, 1) * 65535.0 + 0.5).astype(np.uint16)
        np.testing.assert_array_equal(ours, expect)


def test_png16_codec_round_trip():
    """The 16-bit grey encoder and decoder round-trip every value; the
    decoder reads Pillow's 16-bit grey files, and every other 16-bit or
    interlaced image still raises."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 65536, (17, 23), np.uint16)
    img[0, :4] = [0, 1, 255, 65535]
    data = pgltf._encode_png(img)
    np.testing.assert_array_equal(pgltf._decode_png16(data), img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    np.testing.assert_array_equal(pgltf._decode_png16(buf.getvalue()), img)
    with pytest.raises(ValueError, match="16-bit gray"):
        pgltf._decode_png(data)
    with pytest.raises(ValueError, match="not a 16-bit gray"):
        pgltf._decode_png16(pgltf._encode_png(np.zeros((3, 3, 3), np.uint8)))
    with pytest.raises(ValueError, match="uint16"):
        pgltf._encode_png(np.zeros((3, 3, 3), np.uint16))
    for depth, colour, interlace, msg in ((16, 2, 0, "16-bit RGB"),
                                          (16, 6, 0, "16-bit RGBA"),
                                          (8, 2, 1, "interlaced")):
        png = (pgltf._PNG_SIGNATURE
               + pgltf._png_chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, depth,
                                                       colour, 0, 0, interlace))
               + pgltf._png_chunk(b"IDAT", zlib.compress(b"\0" * 400))
               + pgltf._png_chunk(b"IEND", b""))
        with pytest.raises(ValueError, match=msg):
            pgltf._decode_png(png)
        with pytest.raises(ValueError):
            pgltf._decode_png16(png)


# ---- SaverMixin --------------------------------------------------------------


def test_saver_mixin_with_tensors_matches_jax(tmp_path):
    """Every saver of the port, given CPU tensors, writes the files the JAX
    package's writes from the same arrays (images decoded with Pillow;
    npz / npy loaded)."""
    rng = np.random.default_rng(2)
    img = rng.random((12, 10, 3)).astype(np.float32)
    grey = rng.random((12, 10)).astype(np.float32)
    mask = grey > 0.5
    faces = [rng.random((6, 6, 3)).astype(np.float32) for _ in range(6)]
    state = {"w": rng.random((3, 2)).astype(np.float32),
             "sub": {"b": np.arange(4, dtype=np.int64)}}
    t = torch.from_numpy
    savers = {}
    for name, cls, conv in (("jax", jsaving.SaverMixin, np.asarray),
                            ("port", psaving.SaverMixin, t)):
        s = cls()
        s.set_save_dir(str(tmp_path / name))
        s.save_rgb_image("rgb.png", conv(img))
        s.save_uv_image("uv.png", conv(img), data_range=(0.2, 0.8))
        s.save_grayscale_image("grey.png", conv(grey))
        s.save_grayscale_image("jet.png", conv(grey), cmap="jet")
        s.save_mask_image("mask.png", conv(mask))
        s.save_image_grid("grid.png", [conv(img), conv(mask), conv(grey)],
                          texts=["a", "b"])
        s.save_cubemap("cube.png", [conv(f) for f in faces])
        s.save_npy("a.npy", conv(img))
        s.save_npz("a.npz", x=conv(img), m=conv(mask))
        savers[name] = s
    # the JAX package's checkpoint writer goes through jax.tree_util
    savers["port"].save_state_dict(
        "state.npz", {"w": t(state["w"]), "sub": {"b": t(state["sub"]["b"])}},
        epoch=3, global_step=7)
    for f in ("rgb.png", "uv.png", "grey.png", "jet.png", "mask.png", "grid.png",
              "cube.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / f)),
                                      np.asarray(Image.open(tmp_path / "jax" / f)), f)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "a.npy"),
                                  np.load(tmp_path / "jax" / "a.npy"))
    ours, ref = np.load(tmp_path / "port" / "a.npz"), np.load(tmp_path / "jax" / "a.npz")
    assert sorted(ours.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(ours[k], ref[k])
    ck = np.load(tmp_path / "port" / "state.npz")
    assert sorted(ck.files) == ["__epoch__", "__global_step__", "sub.b", "w"]
    assert int(ck["__epoch__"]) == 3 and int(ck["__global_step__"]) == 7
    np.testing.assert_array_equal(ck["w"], state["w"])
    np.testing.assert_array_equal(ck["sub.b"], state["sub"]["b"])
