"""The port's host mesh IO and the town render against the JAX package.

``worldrenderer_tpu_torch.load_mesh`` and the scene readers (GLB / glTF,
OBJ, PLY, NPZ, the Blender camera path) against the JAX package's on the
same files: the committed town fixture (``tests/data/town.glb``, 5,358
triangles, a 256x768 strip atlas of three materials, and its 100-frame
camera path) and the cases of ``tests/test_scene.py``. The port decodes
and encodes PNG itself (``scene/gltf.py``); its decoder is held against
Pillow on hand-built PNGs of every filter type and colour type it accepts.
Then the town render of ``bench.py:395 bench_town`` at 120x180, frames
[::50]: the port on the CPU within the flip budget of the JAX package's
jitted render, and the backface-cull property of
``tests/test_town_fixture.py`` on the port.

The JAX reference renders are cached for the module, and torch runs on
one thread."""

import base64
import functools
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import worldrenderer_tpu as wr
from worldrenderer_tpu import mesh as jmesh
from worldrenderer_tpu.ops.rasterize import auto_fast_config as j_auto
from worldrenderer_tpu.ops.rasterize import FAST_TPU_CONFIG as J_FAST
from worldrenderer_tpu.scene import camera_json as jcam
from worldrenderer_tpu.scene import gltf as jgltf
from worldrenderer_tpu.scene import ply as jply
from worldrenderer_tpu.transforms import get_clip_space_position as j_clip

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch.scene import camera_json as pcam
from worldrenderer_tpu_torch.scene import gltf as pgltf
from worldrenderer_tpu_torch.scene import ply as pply
from worldrenderer_tpu_torch.utils.debug import counter_totals

DATA = Path(__file__).parent / "data"
GLB = DATA / "town.glb"
CAM_JSON = DATA / "town_camera_path.json"
CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")
MESH_FIELDS = ("v_pos", "t_pos_idx", "v_tex", "t_tex_idx", "texture",
               "stitched_v_pos", "stitched_t_pos_idx", "v_nrm")


@pytest.fixture
def one_torch_thread():
    """Torch on one thread: beside other test processes on the same cores,
    the intra-op threads of the plain versions would wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if x is None:
        return None
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_mesh(pm, jm):
    for f in MESH_FIELDS:
        a, b = _np(getattr(pm, f)), _np(getattr(jm, f))
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)


# ---- the town fixture --------------------------------------------------------

def test_town_loads_equal_to_jax_without_pillow():
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == "PIL" or k.startswith("PIL.")}
    try:
        pm = pt.load_mesh(str(GLB), flip_uv=True, device="cpu")
        assert "PIL" not in sys.modules  # the port's path imports no Pillow
    finally:
        sys.modules.update(saved)
    jm = jmesh.load_mesh(str(GLB), flip_uv=True)
    _same_mesh(pm, jm)
    assert tuple(pm.texture.shape) == (256, 768, 3)
    assert pm.num_faces == 5358
    assert pm.t_pos_idx.dtype == torch.int64
    assert pt.is_registered_quantized_texture(pm.texture)
    assert jmesh.is_registered_quantized_texture(jm.texture)


def test_town_camera_path_equal_to_jax():
    jc, jn, jf = jcam.load_camera_from_json(CAM_JSON, 384, 576)
    pc, pn, pf = pcam.load_camera_from_json(CAM_JSON, 384, 576, device="cpu")
    assert (pn, pf) == (jn, jf)
    assert len(pc) == 100
    np.testing.assert_array_equal(_np(pc.c2w), _np(jc.c2w))
    np.testing.assert_array_equal(_np(pc.cam_pos), _np(jc.cam_pos))
    for f in ("w2c", "proj_mtx", "mvp_mtx"):
        np.testing.assert_allclose(_np(getattr(pc, f)), _np(getattr(jc, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    # The Blender matrices carry a 0.6 scale; w2c still inverts c2w, and
    # the projection keeps get_camera's own near / far (the medians are
    # returned, not applied).
    rot = _np(pc.c2w)[:, :3, :3]
    np.testing.assert_allclose(np.linalg.norm(rot[:, :, 0], axis=-1), 0.6,
                               atol=1e-3)
    rtr = np.einsum("nij,nik->njk", rot, rot)
    np.testing.assert_allclose(rtr / rtr[:, :1, :1],
                               np.broadcast_to(np.eye(3), rtr.shape), atol=1e-4)
    ident = np.einsum("nij,njk->nik", _np(pc.w2c), _np(pc.c2w))
    np.testing.assert_allclose(ident, np.broadcast_to(np.eye(4), ident.shape),
                               atol=1e-4)
    proj = _np(pc.proj_mtx)[0]
    assert abs(proj[2, 3] - (-2.0 * 100.0 * 0.1 / (100.0 - 0.1))) < 1e-6
    assert (pn, pf) == (0.05000000074505806, 500.0)


def test_build_camera_and_json_roundtrip(tmp_path):
    jc = jcam.build_camera(4, 256, 384)
    pc = pcam.build_camera(4, 256, 384, device="cpu")
    for f in CAM_FIELDS:
        np.testing.assert_allclose(_np(getattr(pc, f)), _np(getattr(jc, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    p = tmp_path / "cam.json"
    pcam.save_camera_json(p, pc.c2w, 60.0, clip_start=0.5, clip_end=20.0)
    loaded, near, far = pcam.load_camera_from_json(p, 256, 384, device="cpu")
    assert (near, far) == (0.5, 20.0)
    np.testing.assert_allclose(_np(loaded.c2w), _np(pc.c2w), atol=1e-5)
    np.testing.assert_allclose(_np(loaded.mvp_mtx), _np(pc.mvp_mtx), atol=1e-4)
    j_loaded, _, _ = jcam.load_camera_from_json(p, 256, 384)
    np.testing.assert_array_equal(_np(loaded.c2w), _np(j_loaded.c2w))


# ---- GLB / glTF, PLY, OBJ, NPZ ---------------------------------------------

def _glb(tmp_path, rng, name="m.glb", size=32):
    verts, faces, uv = jmesh.uv_sphere_mesh(9, 17)
    tex = rng.random((size, size, 3)).astype(np.float32)
    p = tmp_path / name
    pgltf.save_glb(p, verts.astype(np.float32), faces.astype(np.uint32),
                   uv=uv, texture=tex)
    return p, verts, faces, uv, tex


def test_glb_roundtrip_both_ways(tmp_path, rng):
    p, verts, faces, uv, tex = _glb(tmp_path, rng)
    out = pgltf.load_glb(p)
    np.testing.assert_allclose(out["vertices"], verts, atol=1e-6)
    np.testing.assert_array_equal(out["faces"], faces)
    np.testing.assert_allclose(out["uv"], uv, atol=1e-6)
    np.testing.assert_array_equal(out["texture"], np.round(tex * 255) / 255.0)
    # The port's file reads the same through the JAX package, and the JAX
    # package's file the same through the port.
    ref = jgltf.load_glb(p)
    jp = tmp_path / "j.glb"
    jgltf.save_glb(jp, verts.astype(np.float32), faces.astype(np.uint32),
                   uv=uv, texture=tex)
    for a, b in ((out, ref), (pgltf.load_glb(jp), jgltf.load_glb(jp))):
        for k in ("vertices", "faces", "uv", "texture"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    pm = pt.load_mesh(str(p), device="cpu")
    _same_mesh(pm, jmesh.load_mesh(str(p)))
    np.testing.assert_allclose(_np(pm.v_tex)[:, 1], 1.0 - uv[:, 1], atol=1e-6)


def test_glb_texture_replacement(tmp_path, rng):
    src, _, faces, _, _ = _glb(tmp_path, rng, "src.glb", 16)
    new_tex = np.zeros((64, 64, 3), np.float32)
    new_tex[:, :, 0] = 1.0
    dst = tmp_path / "dst.glb"
    pgltf.replace_glb_texture(src, dst, new_tex)
    out = pgltf.load_glb(dst)
    assert out["texture"].shape == (64, 64, 3)
    np.testing.assert_array_equal(out["texture"][..., 0], 1.0)
    np.testing.assert_array_equal(out["faces"], faces)
    np.testing.assert_array_equal(jgltf.load_glb(dst)["texture"], out["texture"])
    # The parity wrapper: PBR maps force a fresh single-mesh GLB.
    dst2 = tmp_path / "dst2.glb"
    pgltf.replace_mesh_texture_and_save(
        src, dst2, new_tex, metallic_roughness_texture=new_tex[:8, :8])
    scene = pgltf.parse_glb(dst2)
    assert "metallicRoughnessTexture" in (
        scene.gltf["materials"][0]["pbrMetallicRoughness"])
    np.testing.assert_array_equal(pgltf.load_glb(dst2)["texture"][..., 0], 1.0)


def test_glb_default_white_materials_get_atlas_cells(tmp_path):
    quad_v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    quad_f = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    quad_uv = quad_v[:, :2].astype(np.float32)
    red = np.zeros((8, 8, 3), np.float32)
    red[..., 0] = 1.0
    prims = [
        {"vertices": quad_v, "faces": quad_f, "uv": quad_uv, "texture": red},
        {"vertices": quad_v + [2, 0, 0], "faces": quad_f, "uv": quad_uv},
        {"vertices": quad_v + [4, 0, 0], "faces": quad_f, "uv": quad_uv},
    ]
    p = tmp_path / "m.glb"
    pgltf.save_glb_scene(p, prims)
    scene = pgltf.parse_glb(p)
    del scene.gltf["meshes"][0]["primitives"][2]["material"]
    p2 = tmp_path / "m2.glb"
    p2.write_bytes(pgltf._build_glb(scene.gltf, scene.blob))
    out, ref = pgltf.load_glb(p2), jgltf.load_glb(p2)
    for k in ("vertices", "faces", "uv", "texture"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    tex, uv, ncols = out["texture"], out["uv"], 3
    assert tex.shape[1] == ncols * tex.shape[0]
    cells = [set(np.floor(uv[4 * k:4 * (k + 1), 0] * ncols).astype(int).tolist())
             for k in range(3)]
    assert [len(c) for c in cells] == [1, 1, 1]
    assert len({next(iter(c)) for c in cells}) == 3
    cw = tex.shape[1] // ncols
    for k, expect in [(0, [1, 0, 0]), (1, [1, 1, 1]), (2, [1, 1, 1])]:
        cell = next(iter(cells[k]))
        np.testing.assert_array_equal(tex[tex.shape[0] // 2, cell * cw + cw // 2],
                                      expect)


def test_text_gltf_external_bin_and_data_uri(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2]], np.uint32)
    blob = verts.tobytes() + faces.tobytes()
    (tmp_path / "mesh.bin").write_bytes(blob)
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [1.0, 2.0, 3.0],
                   "rotation": [0.0, 0.0, 0.7071068, 0.7071068],
                   "scale": [2.0, 2.0, 2.0]}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0}, "indices": 1, "mode": 4}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": 6,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": verts.nbytes},
            {"buffer": 0, "byteOffset": verts.nbytes,
             "byteLength": faces.nbytes},
        ],
        "buffers": [{"uri": "mesh.bin", "byteLength": len(blob)}],
    }
    path = tmp_path / "mesh.gltf"
    path.write_text(json.dumps(gltf))
    gltf["buffers"] = [{"uri": "data:application/octet-stream;base64,"
                        + base64.b64encode(blob).decode(),
                        "byteLength": len(blob)}]
    path2 = tmp_path / "mesh_datauri.gltf"
    path2.write_text(json.dumps(gltf))
    for p in (path, path2):
        out, ref = pgltf.load_glb(p), jgltf.load_glb(p)
        np.testing.assert_array_equal(out["vertices"], ref["vertices"])
        np.testing.assert_array_equal(out["faces"], faces.reshape(-1, 3))
        assert out["uv"] is None and out["texture"] is None
        _same_mesh(pt.load_mesh(str(p), merge_vertices=False, device="cpu"),
                   jmesh.load_mesh(str(p), merge_vertices=False))


def test_ply_ascii_and_binary(tmp_path):
    verts = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0], [2, 2, 1]], np.float64)
    nrm = np.array([[0, 0, 1]] * 4, np.float64)
    uv = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    text = "ply\nformat ascii 1.0\nelement vertex 4\n" + "".join(
        f"property float {p}\n" for p in ("x", "y", "z", "nx", "ny", "nz", "s", "t"))
    text += "element face 2\nproperty list uchar int vertex_indices\nend_header\n"
    for i in range(4):
        text += " ".join(str(float(x)) for x in list(verts[i]) + list(nrm[i])
                         + list(uv[i])) + "\n"
    text += "3 0 1 2\n4 0 1 3 2\n"
    pa = tmp_path / "mesh_ascii.ply"
    pa.write_text(text)
    header = ("ply\nformat binary_big_endian 1.0\nelement vertex 4\n"
              + "".join(f"property float {p}\n" for p in ("x", "y", "z"))
              + "element face 1\nproperty list uchar uint vertex_indices\n"
              + "end_header\n")
    body = verts.astype(">f4").tobytes()
    body += np.uint8(3).tobytes() + np.array([0, 1, 2], ">u4").tobytes()
    pb = tmp_path / "mesh_bin.ply"
    pb.write_bytes(header.encode("ascii") + body)
    for p in (pa, pb):
        out, ref = pply.load_ply(p), jply.load_ply(p)
        for k in ("vertices", "faces", "uv", "normals"):
            assert (out[k] is None) == (ref[k] is None), k
            if out[k] is not None:
                np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert pply.load_ply(pa)["faces"].shape == (3, 3)
    _same_mesh(pt.load_mesh(str(pa), default_uv_size=64, device="cpu"),
               jmesh.load_mesh(str(pa), default_uv_size=64))
    _same_mesh(pt.load_mesh(str(pb), device="cpu"), jmesh.load_mesh(str(pb)))


def test_obj_and_npz(tmp_path):
    obj = tmp_path / "m.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nvt 0 0\nvt 1 0\nvt 1 1\n"
        "vt 0 1\nvn 0 0 1\nvn 0 0.6 0.8\nf 1/1/1 2/2/1 3/3/2 4/4/2\n"
        "f -4/-4/-2 -2/-2/-1 -1/-1/-1\n")
    kw = dict(rescale=True, move_to_center=True, shape_init_mesh_up="+z",
              shape_init_mesh_front="-y", front_x_to_y=True,
              default_uv_size=32, return_transform=True)
    pm, p_off, p_scale = pt.load_mesh(str(obj), device="cpu", **kw)
    jm, j_off, j_scale = jmesh.load_mesh(str(obj), **kw)
    _same_mesh(pm, jm)
    np.testing.assert_array_equal(p_off, j_off)
    assert p_scale == j_scale
    plain = tmp_path / "plain.obj"
    plain.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 1 0 0\nf 1 2 3\nf 3 4 1\n")
    _same_mesh(pt.load_mesh(str(plain), device="cpu"), jmesh.load_mesh(str(plain)))
    verts, faces, uv = jmesh.uv_sphere_mesh(5, 7)
    npz = tmp_path / "m.npz"
    np.savez(npz, vertices=verts, faces=faces, uv=uv)
    _same_mesh(pt.load_mesh(str(npz), default_uv_size=16, device="cpu"),
               jmesh.load_mesh(str(npz), default_uv_size=16))
    with pytest.raises(ValueError, match="Unsupported mesh format"):
        pt.load_mesh(str(tmp_path / "m.stl"), device="cpu")


@pytest.mark.parametrize("case", ["town", "grid", "icosphere", "random"])
def test_merge_duplicate_vertices_and_is_watertight(case, rng):
    if case == "town":
        parsed = jgltf.load_glb(GLB)
        v, f = parsed["vertices"], parsed["faces"]
    elif case == "grid":
        v, f = jmesh.make_grid_mesh(9)
    elif case == "icosphere":
        v, f = jmesh.icosphere(2)
    else:
        v = rng.integers(0, 4, (60, 3)).astype(np.float64) * 0.5
        f = rng.integers(0, 60, (40, 3))
    pv, pf = pt.merge_duplicate_vertices(v, f)
    jv, jf = jmesh.merge_duplicate_vertices(v, f)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jf)
    for faces in (f, jf, jf[:-1], jf[:, ::-1]):
        assert pt.is_watertight(faces) == jmesh.is_watertight(faces)
        assert pt.is_watertight(torch.from_numpy(np.ascontiguousarray(faces))) \
            == jmesh.is_watertight(faces)
    if case == "icosphere":
        assert pt.is_watertight(jf) and not pt.is_watertight(jf[:-1])


# ---- the PNG codec ---------------------------------------------------------

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filtered(rows, kinds, bpp):
    """Rows of bytes (H, N) filtered with the given per-row filter types."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for row, k in zip(rows.astype(np.int64), kinds):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) >> 1, paeth][k]
        out.append(bytes([k]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png(pixels, colour, depth=8, kinds=None, palette=None, interlace=0):
    """A PNG of raw samples (H, W, C) (sub-byte samples packed per row)."""
    h, w = pixels.shape[:2]
    flat = pixels.reshape(h, -1).astype(np.uint8)
    if depth < 8:
        bits = np.unpackbits(flat[..., None], axis=-1)[..., 8 - depth:]
        bits = bits.reshape(h, -1)
        pad = (-bits.shape[1]) % 8
        flat = np.packbits(np.pad(bits, ((0, 0), (0, pad))), axis=1)
    bpp = max(1, pixels.shape[2] * depth // 8)
    kinds = kinds if kinds is not None else [k % 5 for k in range(h)]
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                       interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data = zlib.compress(_filtered(flat, kinds, bpp))
    body += _chunk(b"IDAT", data[:7]) + _chunk(b"IDAT", data[7:])
    return b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b"")


def _pillow_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("colour, depth", [
    (0, 8), (2, 8), (3, 8), (4, 8), (6, 8), (0, 1), (0, 2), (0, 4), (3, 1),
    (3, 2), (3, 4),
])
def test_png_decoder_matches_pillow(colour, depth, rng):
    h, w = 23, 19
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    top = 1 << depth
    palette = None
    if colour == 3:
        palette = rng.integers(0, 256, (top, 3))
    pix = rng.integers(0, top, (h, w, samples))
    pix[:4] = pix[:1]  # flat stretches, where Sub and Up predict well
    for kinds in ([k % 5 for k in range(h)], [4] * h, [3] * h):
        data = _png(pix, colour, depth, kinds, palette)
        got = pgltf._decode_png(data)
        np.testing.assert_array_equal(got, _pillow_rgb(data))
        np.testing.assert_array_equal(pgltf._decode_image(data),
                                      got.astype(np.float32) / 255.0)


def test_png_decoder_reads_pillow_files_and_encoder_round_trips(rng):
    img = (rng.random((31, 45, 3)) * 255).astype(np.uint8)
    img[5:20, 10:30] = 200  # flat regions make the encoder pick Sub / Up
    for mode in ("RGB", "L", "LA", "RGBA", "P"):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, format="PNG")
        np.testing.assert_array_equal(pgltf._decode_png(buf.getvalue()),
                                      _pillow_rgb(buf.getvalue()))
    for arr in (img, img[..., 0], np.dstack([img, img[..., :1]]),
                img[..., :2], rng.random((7, 9, 3)).astype(np.float32)):
        data = pgltf._encode_png(arr)
        ref = np.asarray(Image.open(io.BytesIO(data)))
        want = arr if arr.dtype == np.uint8 else (arr * 255.0 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(ref, want)
        np.testing.assert_array_equal(pgltf._decode_png(data), _pillow_rgb(data))


def _header_png(depth, colour, interlace=0):
    """A PNG whose header alone decides: 4x4 of zero rows."""
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, colour, 0,
                                          0, interlace))
            + _chunk(b"IDAT", zlib.compress(bytes(4 * 33)))
            + _chunk(b"IEND", b""))


def test_png_decoder_names_what_it_refuses(rng):
    for depth, colour, name in ((16, 2, "16-bit RGB"), (16, 6, "16-bit RGBA"),
                                (4, 2, "4-bit RGB"), (8, 5, "colour type 5")):
        with pytest.raises(ValueError, match=name):
            pgltf._decode_image(_header_png(depth, colour))
    raw16 = io.BytesIO()
    Image.fromarray((rng.random((4, 4)) * 65535).astype(np.uint16)).save(
        raw16, format="PNG")
    with pytest.raises(ValueError, match="16-bit gray"):
        pgltf._decode_image(raw16.getvalue())
    with pytest.raises(ValueError, match="interlaced"):
        pgltf._decode_image(_png(rng.integers(0, 256, (4, 4, 3)), 2,
                                 interlace=1))
    jpeg = io.BytesIO()
    Image.fromarray((rng.random((8, 8, 3)) * 255).astype(np.uint8)).save(
        jpeg, format="JPEG")
    with pytest.raises(ValueError, match="JPEG"):
        pgltf._decode_image(jpeg.getvalue())
    broken = bytearray(_png(rng.integers(0, 256, (4, 4, 3)), 2))
    broken[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        pgltf._decode_image(bytes(broken))


# ---- the town render ---------------------------------------------------------

TOWN_H, TOWN_W = 120, 180


@functools.lru_cache(maxsize=None)
def _town(port_cull=-1):
    """(JAX mesh, JAX camera of frames [::50], port mesh, port camera,
    JAX config with exact fp32 dots, port config) of bench_town's render at
    120x180, configs from both packages' auto_fast_config."""
    jm = jmesh.load_mesh(str(GLB), flip_uv=True)
    jc, _, _ = jcam.load_camera_from_json(CAM_JSON, TOWN_H, TOWN_W)
    jc = jax.tree_util.tree_map(lambda x: x[::50], jc)
    pm = pt.load_mesh(str(GLB), flip_uv=True, device="cpu")
    pc, _, _ = pcam.load_camera_from_json(CAM_JSON, TOWN_H, TOWN_W, device="cpu")
    pc = pc[::50]
    jcfg = j_auto(j_clip(jm.v_pos, jc.mvp_mtx), jm.t_pos_idx, (TOWN_H, TOWN_W),
                  base=J_FAST._replace(backface_cull=port_cull))
    pcfg = pt.auto_fast_config(pt.get_clip_space_position(pm.v_pos, pc.mvp_mtx),
                               pm.t_pos_idx, (TOWN_H, TOWN_W),
                               base=pt.FAST_TPU_CONFIG._replace(
                                   backface_cull=port_cull))
    assert tuple(pcfg) == tuple(jcfg)
    return jm, jc, pm, pc, jcfg._replace(dot_precision="highest"), pcfg


RENDER_KW = dict(render_attr=True, render_depth=True, render_normal=True,
                 attr_background=0.7)


def test_town_render_within_flip_budget_of_jitted_jax(one_torch_thread):
    """bench_town's whole render (the loaded mesh and camera path, the
    atlas sampled at attr_background 0.7, depth, normals) against the JAX
    package's jitted render. The two clip transforms round apart (ROADMAP
    queue 3's open entry), and the path's near / far of 0.1 / 100 puts
    the town at NDC z near 1, where the unprojection and the depth
    normalization magnify that spread (the JAX package's own jitted and
    op-by-op renders differ the same way): masks must agree to 1e-4 of
    foreground; a pixel whose normal moves by more than 5e-4 (another
    triangle won it), or whose colour or depth moves by more than 1e-2,
    counts as a flip, at most max(16, fg // 2000) of them, the id budget
    of tests/test_town_fixture.py."""
    jm, jc, pm, pc, jcfg, pcfg = _town()
    assert pcfg.backend == "fused_pallas" and pcfg.backface_cull == -1
    before = counter_totals().get("launch.k1", 0)
    po = pt.render(pm, pc, TOWN_H, TOWN_W, raster_config=pcfg, device="cpu",
                   **RENDER_KW)
    assert counter_totals().get("launch.k1", 0) == before  # the CPU path does not launch
    jo = jax.jit(functools.partial(wr.render, height=TOWN_H, width=TOWN_W,
                                   raster_config=jcfg, **RENDER_KW))(jm, jc)
    m = _np(jo.mask)
    fg = int(m.sum())
    cov = m.mean(axis=(1, 2))
    assert (cov > 0.15).all() and (cov < 0.95).all(), cov
    assert int((_np(po.mask) != m).sum()) <= 1e-4 * fg
    both = _np(po.mask) & m
    budget = max(16, fg // 2000)
    for f, atol in (("normal", 5e-4), ("attr", 1e-2), ("depth", 1e-2)):
        d = np.abs(_np(getattr(po, f)) - _np(getattr(jo, f)))
        d = d.max(-1) if d.ndim == 4 else d
        assert int((d[both] > atol).sum()) <= budget, (f, budget)
    for f in ("attr", "pos", "depth", "normal"):
        assert np.isfinite(_np(getattr(po, f))).all(), f
    assert _np(po.attr)[both].std() > 0.1  # the atlas's cells show


def test_town_backface_cull_invariance_on_the_port(one_torch_thread):
    _, _, pm, pc, _, _ = _town()
    pos = pt.get_clip_space_position(pm.v_pos, pc.mvp_mtx)
    outs = {}
    for bf in (0, -1):
        cfg = pt.auto_fast_config(pos, pm.t_pos_idx, (TOWN_H, TOWN_W),
                                  backface_cull=bf)
        outs[bf] = pt.rasterize_gbuffer(pos, pm.t_pos_idx, None,
                                        (TOWN_H, TOWN_W), cfg, device="cpu")
    a, b = outs[0], outs[-1]
    assert int((a.mask != b.mask).sum()) == 0, "cull changed coverage"
    both = a.mask & b.mask
    flips = int(((a.tri_id != b.tri_id) & both).sum())
    fg = int(both.sum())
    assert fg > 0.15 * both.numel()
    assert flips <= max(16, fg // 2000), (flips, fg)
    same = both & (a.tri_id == b.tri_id)
    assert float((a.z - b.z).abs()[same].max()) < 1e-5
