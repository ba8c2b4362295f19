"""Self-contained GLB (glTF 2.0 binary) and glTF reader / writer, numpy
only (a copy of ``worldrenderer_tpu/scene/gltf.py`` for the PyTorch port,
which imports nothing of the JAX package).

JSON chunk + BIN chunk parsing, text glTF with external or data-URI
buffers, node-hierarchy flattening with world transforms, primitive
concatenation, baseColor texture extraction into a strip atlas, and texture
replacement that patches the image bytes in place.

Only the features the pipelines need are implemented: triangle primitives,
POSITION / TEXCOORD_0 / NORMAL attributes, and PNG images, decoded and
encoded here with ``zlib`` and numpy (8-bit gray, gray + alpha, RGB and
RGBA, palette at 1, 2, 4 or 8 bits, every filter type; not interlaced;
16-bit gray through ``_encode_png`` / ``_decode_png16``, for depth frames).
Any other image (16-bit or interlaced PNG, JPEG) raises ``ValueError``.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "parse_glb",
    "load_glb",
    "save_glb",
    "replace_glb_texture",
    "replace_mesh_texture_and_save",
    "save_glb_scene",
    "GLBScene",
]

_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GLBScene:
    """Parsed glTF: JSON dict + binary buffers, with accessor helpers.

    ``buffers`` holds one bytes object per glTF buffer (a GLB has exactly
    one — the BIN chunk; a text .gltf may reference several external /
    data-URI buffers, reference trimesh loader parity:
    mvadapter/utils/mesh_utils/mesh.py:198-345)."""

    def __init__(self, gltf: dict, blob=b"", buffers: Optional[list] = None):
        self.gltf = gltf
        self.buffers = list(buffers) if buffers is not None else [blob]

    @property
    def blob(self) -> bytes:
        return self.buffers[0] if self.buffers else b""

    # -- low-level ----------------------------------------------------------
    def buffer_view_bytes(self, bv_index: int) -> bytes:
        bv = self.gltf["bufferViews"][bv_index]
        off = bv.get("byteOffset", 0)
        buf = self.buffers[bv.get("buffer", 0)]
        return buf[off : off + bv["byteLength"]]

    def accessor_array(self, acc_index: int) -> np.ndarray:
        acc = self.gltf["accessors"][acc_index]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        ncomp = _TYPE_SIZES[acc["type"]]
        count = acc["count"]
        bv = self.gltf["bufferViews"][acc["bufferView"]]
        buf = self.buffers[bv.get("buffer", 0)]
        base = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or dtype().itemsize * ncomp
        itemsize = dtype().itemsize * ncomp
        if stride == itemsize:
            arr = np.frombuffer(buf, dtype=dtype, count=count * ncomp, offset=base)
        else:  # interleaved
            rows = [
                np.frombuffer(buf, dtype=dtype, count=ncomp, offset=base + i * stride)
                for i in range(count)
            ]
            arr = np.concatenate(rows)
        return arr.reshape(count, ncomp) if ncomp > 1 else arr

    def image_bytes(self, image_index: int) -> Tuple[bytes, str]:
        img = self.gltf["images"][image_index]
        mime = img.get("mimeType", "image/png")
        if "bufferView" in img:
            return self.buffer_view_bytes(img["bufferView"]), mime
        return _resolve_uri(img["uri"], getattr(self, "base_dir", None)), mime


def _resolve_uri(uri: str, base_dir) -> bytes:
    """Resolve a glTF buffer/image URI: data: URIs inline, anything else a
    path relative to the .gltf file."""
    if uri.startswith("data:"):
        import base64

        header, _, payload = uri.partition(",")
        if ";base64" in header:
            return base64.b64decode(payload)
        from urllib.parse import unquote_to_bytes

        return unquote_to_bytes(payload)
    if base_dir is None:
        raise ValueError(f"external buffer {uri!r} needs a base directory")
    from urllib.parse import unquote

    return (Path(base_dir) / unquote(uri)).read_bytes()


def _node_world_transforms(gltf: dict) -> Dict[int, np.ndarray]:
    """Flatten the node hierarchy into per-node 4x4 world matrices."""
    nodes = gltf.get("nodes", [])

    def local(node) -> np.ndarray:
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "scale" in node:
            m = m @ np.diag(list(node["scale"]) + [1.0])
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            r = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                ]
            )
            rm = np.eye(4)
            rm[:3, :3] = r
            m = rm @ m
        if "translation" in node:
            tm = np.eye(4)
            tm[:3, 3] = node["translation"]
            m = tm @ m
        return m

    world: Dict[int, np.ndarray] = {}

    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [{"nodes": list(range(len(nodes)))}])
    roots = scenes[scene_idx].get("nodes", [])

    def visit(i: int, parent: np.ndarray):
        m = parent @ local(nodes[i])
        world[i] = m
        for child in nodes[i].get("children", []):
            visit(child, m)

    for r in roots:
        visit(r, np.eye(4))
    # Unreferenced nodes get identity-rooted transforms.
    for i in range(len(nodes)):
        if i not in world:
            world[i] = local(nodes[i])
    return world


def parse_glb(path) -> GLBScene:
    data = Path(path).read_bytes()
    if len(data) < 12 or data[:4] != b"glTF":
        # Text .gltf: JSON document with external-file or data: URI buffers.
        try:
            gltf = json.loads(data.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise ValueError(f"{path}: neither a GLB nor a glTF JSON file")
        base_dir = Path(path).parent
        buffers = [
            _resolve_uri(b["uri"], base_dir) if "uri" in b else b""
            for b in gltf.get("buffers", [])
        ] or [b""]
        scene = GLBScene(gltf, buffers=buffers)
        scene.base_dir = base_dir
        return scene
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a GLB file")
    if version != 2:
        raise ValueError(f"{path}: unsupported glTF version {version}")
    offset = 12
    gltf = None
    blob = b""
    while offset < len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + clen]
        offset += clen
        if ctype == _CHUNK_JSON:
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == _CHUNK_BIN:
            blob = bytes(chunk)
    if gltf is None:
        raise ValueError(f"{path}: missing JSON chunk")
    return GLBScene(gltf, blob)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> (name, samples per pixel).
_PNG_COLOUR = {0: ("gray", 1), 2: ("RGB", 3), 3: ("palette", 1),
               4: ("gray + alpha", 2), 6: ("RGBA", 4)}


def _png_chunks(data: bytes):
    """(type, payload) of each chunk of a PNG file, CRCs checked."""
    off = len(_PNG_SIGNATURE)
    while off + 12 <= len(data):
        (n,) = struct.unpack_from(">I", data, off)
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + n]
        (crc,) = struct.unpack_from(">I", data, off + 8 + n)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        off += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before its IEND chunk")


def _png_unfilter(raw: bytes, height: int, row_bytes: int,
                  bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: (height, row_bytes) uint8.

    Each byte depends on its left neighbour (``bpp`` bytes back), the byte
    above and the one above-left, so the rows are reconstructed along
    anti-diagonals of (row, pixel): every step is one vectorized pass over
    the rows it reaches, whatever mix of None, Sub, Up, Average and Paeth
    they use."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != height * (row_bytes + 1):
        raise ValueError("PNG image data has the wrong length")
    data = data.reshape(height, row_bytes + 1)
    kinds = data[:, 0].astype(np.int32)
    if (kinds > 4).any():
        raise ValueError(f"PNG filter type {int(kinds.max())} is not defined")
    if not kinds.any():  # every row unfiltered, as _encode_png writes them
        return data[:, 1:].copy()
    groups = row_bytes // bpp
    filt = data[:, 1:].reshape(height, groups, bpp).astype(np.int32)
    # One row and one group of zeros before the image: the bytes "above"
    # row 0 and "left of" group 0.
    out = np.zeros((height + 1, groups + 1, bpp), np.int32)
    rows = np.arange(height)
    for k in range(height + groups - 1):
        y = rows[max(0, k - groups + 1):min(height, k + 1)]
        x = k - y
        a = out[y + 1, x]  # left
        b = out[y, x + 1]  # above
        c = out[y, x]  # above-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = kinds[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    return out[1:, 1:].reshape(height, row_bytes).astype(np.uint8)


def _png_parts(data: bytes):
    """(width, height, bit depth, colour type, palette or None, inflated
    image data) of a PNG file that is not interlaced."""
    header = None
    palette = None
    idat = []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _PNG_COLOUR:
        raise ValueError(f"PNG colour type {colour} is not defined")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG images are not supported")
    return width, height, depth, colour, palette, zlib.decompress(b"".join(idat))


def _decode_png16(data: bytes) -> np.ndarray:
    """A 16-bit gray PNG (what ``_encode_png`` writes of a uint16 image) as
    (H, W) uint16; any other PNG raises ``ValueError``."""
    width, height, depth, colour, _, raw = _png_parts(data)
    if (depth, colour) != (16, 0):
        raise ValueError(f"not a 16-bit gray PNG image ({depth}-bit "
                         f"{_PNG_COLOUR[colour][0]})")
    rows = _png_unfilter(raw, height, 2 * width, 2)
    return rows.view(">u2").reshape(height, width).astype(np.uint16)


def _decode_png(data: bytes) -> np.ndarray:
    """A PNG as (H, W, 3) uint8 RGB: gray is repeated, alpha dropped and a
    palette looked up (what ``convert("RGB")`` of an image library gives)."""
    width, height, depth, colour, palette, raw = _png_parts(data)
    name, samples = _PNG_COLOUR[colour]
    if depth == 16:
        raise ValueError(f"16-bit {name} PNG images are not supported")
    if depth != 8 and not (colour in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"{depth}-bit {name} PNG images are not supported")
    bits_per_pixel = samples * depth
    row_bytes = -(-width * bits_per_pixel // 8)
    rows = _png_unfilter(raw, height, row_bytes, max(1, bits_per_pixel // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :width * depth]
        weights = 1 << np.arange(depth - 1, -1, -1)
        px = (bits.reshape(height, width, depth) * weights).sum(-1)
        px = px.astype(np.uint8)[..., None]
    else:
        px = rows.reshape(height, width, samples)
    if colour == 3:
        if palette is None:
            raise ValueError("palette PNG image has no PLTE chunk")
        idx = px[..., 0]
        if idx.size and int(idx.max()) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[idx]
    if colour in (0, 4):
        gray = px[..., 0]
        if depth < 8:
            gray = (gray.astype(np.int32) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=-1)
    return px[..., :3]


def _decode_image(data: bytes) -> np.ndarray:
    """An image file as (H, W, 3) float32 in [0, 1] (k/255 values)."""
    if data[:8] == _PNG_SIGNATURE:
        return _decode_png(data).astype(np.float32) / 255.0
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError("JPEG images are not supported; only PNG is decoded")
    raise ValueError("unrecognized image format; only PNG is decoded")


def load_glb(path):
    """Load a GLB into concatenated numpy arrays.

    Returns dict with: vertices (V,3) f64, faces (T,3) i64, uv (V,2) f32 or
    None, texture (H,W,3) f32 or None, normals (V,3) or None.
    All primitives are flattened into world space and concatenated
    (reference mesh.py:215-230 scene concatenation semantics).

    Multi-material scenes (the town.blend-class fixture shape: several
    primitives, each with its own baseColor texture or factor) are
    flattened into ONE texture by packing each material's image into a
    horizontal strip ATLAS and remapping that primitive's UVs into its cell —
    the renderer then samples a single texture exactly as the reference's
    concatenated-scene path does. UVs are clamped to [0, 1] during the
    remap, so REPEAT-wrap tiling beyond the unit square is not preserved
    (a per-cell limitation of any atlas; bake pipelines regenerate UVs
    anyway). Untextured materials contribute a constant baseColorFactor
    cell (spec-default white when the factor is absent); material-less
    primitives get a white cell too — the glTF default material."""
    scene = parse_glb(path)
    gltf = scene.gltf
    world = _node_world_transforms(gltf)

    verts_all: List[np.ndarray] = []
    faces_all: List[np.ndarray] = []
    uv_all: List[np.ndarray] = []
    nrm_all: List[np.ndarray] = []
    prim_mat: List[Optional[int]] = []  # material index per primitive
    has_uv = True
    has_nrm = True
    vert_base = 0

    mesh_nodes = [
        (i, n["mesh"]) for i, n in enumerate(gltf.get("nodes", [])) if "mesh" in n
    ]
    if not mesh_nodes:
        mesh_nodes = [(-1, mi) for mi in range(len(gltf.get("meshes", [])))]

    for node_idx, mesh_idx in mesh_nodes:
        xform = world.get(node_idx, np.eye(4))
        nrm_xform = np.linalg.inv(xform[:3, :3]).T
        for prim in gltf["meshes"][mesh_idx]["primitives"]:
            if prim.get("mode", 4) != 4:
                continue  # triangles only
            attrs = prim["attributes"]
            pos = scene.accessor_array(attrs["POSITION"]).astype(np.float64)
            pos = pos @ xform[:3, :3].T + xform[:3, 3]
            if "indices" in prim:
                idx = scene.accessor_array(prim["indices"]).astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            faces = idx.reshape(-1, 3) + vert_base
            verts_all.append(pos)
            faces_all.append(faces)

            if "TEXCOORD_0" in attrs:
                uv_all.append(scene.accessor_array(attrs["TEXCOORD_0"]).astype(np.float32))
            else:
                has_uv = False
                uv_all.append(np.zeros((len(pos), 2), np.float32))
            if "NORMAL" in attrs:
                nrm = scene.accessor_array(attrs["NORMAL"]).astype(np.float64)
                nrm_all.append(nrm @ nrm_xform.T)
            else:
                has_nrm = False
            prim_mat.append(prim.get("material"))
            vert_base += len(pos)

    if not verts_all:
        raise ValueError(f"{path}: no triangle geometry found")

    # ---- material resolution: one texture (or factor cell) per material.
    def _mat_image(mi):
        """Image for a material, or None when it carries neither a
        baseColorTexture nor an explicit baseColorFactor (spec default =
        white — resolved below, where it matters whether ANY material has
        real content)."""
        mat = gltf["materials"][mi]
        pbr = mat.get("pbrMetallicRoughness", {})
        bct = pbr.get("baseColorTexture")
        if bct is not None:
            tex = gltf["textures"][bct["index"]]
            if "source" in tex:
                img_bytes, _ = scene.image_bytes(tex["source"])
                return _decode_image(img_bytes)
        factor = pbr.get("baseColorFactor")
        if factor is not None:
            return np.broadcast_to(
                np.asarray(factor[:3], np.float32), (4, 4, 3)
            ).copy()
        return None

    used_mats = sorted({m for m in prim_mat if m is not None})
    images = {m: _mat_image(m) for m in used_mats}
    explicit = [m for m in used_mats if images[m] is not None]
    has_matless_prims = any(m is None for m in prim_mat)

    texture = None
    uv = np.concatenate(uv_all, axis=0) if has_uv and uv_all else None
    textured = []
    if explicit:
        # Every material gets an atlas cell once ANY material has real
        # content: per the glTF spec an absent baseColorFactor defaults to
        # [1,1,1,1], so default-white materials — and material-less
        # primitives (keyed None) — get a white cell, NOT "no cell"
        # (un-remapped UVs would sample arbitrary texels from other
        # materials' cells).
        textured = list(used_mats)
        for m in used_mats:
            if images[m] is None:
                images[m] = np.ones((4, 4, 3), np.float32)
        if has_matless_prims:
            images[None] = np.ones((4, 4, 3), np.float32)
            textured.append(None)
    if len(textured) == 1 and not has_matless_prims:
        # Exactly one material: keep texture + UVs untouched (a 1-cell
        # "atlas" would only add a clamp + half-texel inset).
        texture = images[textured[0]]
    elif len(textured) >= 1:
        # Strip atlas: all cells in ONE horizontal row (cell = the largest
        # image's size; smaller images are nearest-upsampled). A single
        # row makes the remap EQUIVARIANT to the loader's global V-flip
        # (mesh.load_mesh flip_uv does v -> 1-v): v stays within-cell, u
        # is never flipped, so cell assignment survives any v convention.
        ncols = len(textured)
        ch = max(images[m].shape[0] for m in textured)
        cw = max(images[m].shape[1] for m in textured)
        atlas = np.zeros((ch, ncols * cw, 3), np.float32)
        col_of = {}
        for k, m in enumerate(textured):
            img = images[m]
            if img.shape[:2] != (ch, cw):
                ry = (np.arange(ch) * img.shape[0] // ch).clip(0, img.shape[0] - 1)
                rx = (np.arange(cw) * img.shape[1] // cw).clip(0, img.shape[1] - 1)
                img = img[ry][:, rx]
            atlas[:, k * cw:(k + 1) * cw] = img
            col_of[m] = k
        texture = atlas
        if uv is not None:
            uv = uv.copy()
            base = 0
            for pos, pm in zip(verts_all, prim_mat):
                n_v = len(pos)
                if pm in col_of:
                    c = col_of[pm]
                    seg = np.clip(uv[base:base + n_v], 0.0, 1.0)
                    # Half-texel inset keeps bilinear taps inside the cell.
                    iy, ix = 0.5 / ch, 0.5 / cw
                    seg = seg * [1 - 2 * ix, 1 - 2 * iy] + [ix, iy]
                    uv[base:base + n_v, 0] = (seg[:, 0] + c) / ncols
                    uv[base:base + n_v, 1] = seg[:, 1]
                base += n_v

    return {
        "vertices": np.concatenate(verts_all, axis=0),
        "faces": np.concatenate(faces_all, axis=0),
        "uv": uv,
        "normals": np.concatenate(nrm_all, axis=0) if has_nrm and nrm_all else None,
        "texture": texture,
    }


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _encode_png(image: np.ndarray) -> bytes:
    """An (H, W) gray or (H, W, 2 / 3 / 4) image, float in [0, 1] or uint8,
    as an 8-bit PNG, or an (H, W) uint16 image as a 16-bit gray PNG (its
    samples big-endian), with filter type 0 (None) on every row. A uint8
    image is written as it is (the JAX package's writer clips it to [0, 1]
    first, which under NumPy 2 turns it into float and its bytes into 255
    or 0)."""
    arr = np.asarray(image)
    if arr.dtype == np.uint16:
        if arr.ndim != 2:
            raise ValueError(f"cannot encode a uint16 image of shape {arr.shape} "
                             "as PNG: only (H, W) gray")
        return _png_bytes(arr.astype(">u2").view(np.uint8), arr.shape[1], 16, 0)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    colour = {1: 0, 2: 4, 3: 2, 4: 6}.get(arr.shape[-1])
    if arr.ndim != 3 or colour is None:
        raise ValueError(f"cannot encode an image of shape {arr.shape} as PNG")
    return _png_bytes(arr.reshape(arr.shape[0], -1), arr.shape[1], 8, colour)


def _png_bytes(rows: np.ndarray, width: int, depth: int, colour: int) -> bytes:
    """A PNG file of (H, row bytes) uint8 image rows, unfiltered."""
    height = rows.shape[0]
    rows = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    return (_PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                              colour, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def _pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
    return b + fill * ((4 - len(b) % 4) % 4)


def _build_glb(gltf: dict, blob: bytes) -> bytes:
    js = _pad4(json.dumps(gltf, separators=(",", ":")).encode("utf-8"), b" ")
    blob = _pad4(blob)
    total = 12 + 8 + len(js) + 8 + len(blob)
    out = struct.pack("<III", _MAGIC, 2, total)
    out += struct.pack("<II", len(js), _CHUNK_JSON) + js
    out += struct.pack("<II", len(blob), _CHUNK_BIN) + blob
    return out


def save_glb_scene(path, primitives, node_transform=None) -> None:
    """Write a multi-primitive / multi-material GLB (the town.blend-class
    scene shape: several parts, each with its own baseColor texture or
    factor). ``primitives`` is a list of dicts with keys:

      vertices (V,3), faces (T,3)   required
      uv (V,2), normals (V,3)       optional per-vertex attributes
      texture (H,W,3) float [0,1]   optional baseColor texture
      base_color (3,)               optional baseColorFactor (no texture)
      metallic_roughness_texture / normal_texture   optional PBR maps
      name                          optional material name

    ``node_transform`` (4,4): optional world transform on the single scene
    node (e.g. a non-unit scale — real exported scenes rarely sit in a
    unit cube; load_glb flattens it back into world space)."""
    blob = b""
    buffer_views = []
    accessors = []

    def add_view(data: bytes, target: Optional[int] = None) -> int:
        nonlocal blob
        blob = _pad4(blob)
        bv = {"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)}
        if target is not None:
            bv["target"] = target
        blob += data
        buffer_views.append(bv)
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, ctype: int, atype: str, target: int) -> int:
        bv = add_view(arr.tobytes(), target)
        acc = {
            "bufferView": bv,
            "componentType": ctype,
            "count": len(arr),
            "type": atype,
        }
        if atype == "VEC3" and ctype == 5126:
            acc["min"] = arr.min(axis=0).tolist()
            acc["max"] = arr.max(axis=0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    images = []
    textures = []
    samplers = [{"magFilter": 9729, "minFilter": 9987, "wrapS": 10497, "wrapT": 10497}]

    def add_texture(img: np.ndarray) -> int:
        bv = add_view(_encode_png(img))
        images.append({"bufferView": bv, "mimeType": "image/png"})
        textures.append({"sampler": 0, "source": len(images) - 1})
        return len(textures) - 1

    prims_json = []
    materials = []
    for k, prim in enumerate(primitives):
        vertices = np.asarray(prim["vertices"], np.float32)
        faces = np.asarray(prim["faces"], np.uint32)
        attrs = {"POSITION": add_accessor(vertices, 5126, "VEC3", 34962)}
        if prim.get("normals") is not None:
            attrs["NORMAL"] = add_accessor(
                np.asarray(prim["normals"], np.float32), 5126, "VEC3", 34962
            )
        if prim.get("uv") is not None:
            attrs["TEXCOORD_0"] = add_accessor(
                np.asarray(prim["uv"], np.float32), 5126, "VEC2", 34962
            )
        idx_acc = add_accessor(faces.reshape(-1), 5125, "SCALAR", 34963)

        material = {
            "name": prim.get("name", f"material_{k}"),
            "pbrMetallicRoughness": {},
        }
        if prim.get("texture") is not None and prim.get("uv") is not None:
            material["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": add_texture(prim["texture"])
            }
        elif prim.get("base_color") is not None:
            material["pbrMetallicRoughness"]["baseColorFactor"] = (
                list(np.asarray(prim["base_color"], np.float32).tolist()) + [1.0]
            )[:4]
        if prim.get("metallic_roughness_texture") is not None:
            material["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {
                "index": add_texture(prim["metallic_roughness_texture"])
            }
        if prim.get("normal_texture") is not None:
            material["normalTexture"] = {
                "index": add_texture(prim["normal_texture"])
            }
        materials.append(material)
        prims_json.append(
            {"attributes": attrs, "indices": idx_acc, "material": k, "mode": 4}
        )

    node = {"mesh": 0}
    if node_transform is not None:
        # glTF matrices are column-major flattened.
        node["matrix"] = np.asarray(
            node_transform, np.float32
        ).T.reshape(-1).tolist()
    gltf = {
        "asset": {"version": "2.0", "generator": "worldrenderer_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [node],
        "meshes": [{"primitives": prims_json}],
        "materials": materials,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(_pad4(blob))}],
    }
    if images:
        gltf["images"] = images
        gltf["textures"] = textures
        gltf["samplers"] = samplers

    Path(path).write_bytes(_build_glb(gltf, blob))


def save_glb(
    path,
    vertices: np.ndarray,
    faces: np.ndarray,
    uv: Optional[np.ndarray] = None,
    texture: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    metallic_roughness_texture: Optional[np.ndarray] = None,
    normal_texture: Optional[np.ndarray] = None,
) -> None:
    """Write a single-mesh GLB (reference replace_mesh_texture_and_save
    output shape, mesh.py:348-526): positions + indices (+ UVs, baseColor /
    metallicRoughness / normal textures). One-primitive wrapper over
    :func:`save_glb_scene`."""
    save_glb_scene(
        path,
        [{
            "vertices": vertices,
            "faces": faces,
            "uv": uv,
            "texture": None if uv is None else texture,
            "normals": normals,
            "metallic_roughness_texture": metallic_roughness_texture,
            "normal_texture": normal_texture,
            "name": "baked",
        }],
    )


def replace_mesh_texture_and_save(
    mesh_path,
    save_path,
    texture,
    metallic_roughness_texture=None,
    normal_texture=None,
    normal_strength: float = 1.0,
    backend: str = "native",
    task_id: str = "",
) -> None:
    """API-parity wrapper (reference mesh.py:348-526 signature): write the
    baked texture (plus optional PBR maps) into the mesh's GLB. The
    trimesh/gltflib backend split of the reference collapses to the native
    writer; PBR maps force a fresh single-mesh GLB."""
    del backend, task_id, normal_strength  # parity args
    texture = np.asarray(texture, np.float32)
    if metallic_roughness_texture is None and normal_texture is None:
        try:
            replace_glb_texture(mesh_path, save_path, texture)
            return
        except ValueError:
            pass  # source had no baseColor slot — write a fresh GLB below
    parsed = load_glb(mesh_path)
    save_glb(
        save_path,
        vertices=parsed["vertices"].astype(np.float32),
        faces=parsed["faces"].astype(np.uint32),
        uv=parsed["uv"],
        normals=None if parsed["normals"] is None else parsed["normals"].astype(np.float32),
        texture=texture,
        metallic_roughness_texture=metallic_roughness_texture,
        normal_texture=normal_texture,
    )


def replace_glb_texture(src_path, dst_path, texture: np.ndarray) -> None:
    """Patch the baseColor texture image bytes of an existing GLB, keeping
    all other content identical (reference mesh.py:348-526 'replace texture
    and save' semantics, trimesh/gltflib-free)."""
    scene = parse_glb(src_path)
    gltf = scene.gltf

    # Find the baseColor image index of the first textured material.
    img_index = None
    for mat in gltf.get("materials", []):
        bct = mat.get("pbrMetallicRoughness", {}).get("baseColorTexture")
        if bct is not None:
            img_index = gltf["textures"][bct["index"]].get("source")
            break
    if img_index is None:
        raise ValueError(f"{src_path}: no baseColor texture to replace")

    png = _encode_png(texture)
    old_bv_idx = gltf["images"][img_index]["bufferView"]

    # Append the new image at the end of the blob; repoint the bufferView.
    blob = _pad4(scene.blob)
    new_bv = {"buffer": 0, "byteOffset": len(blob), "byteLength": len(png)}
    blob += png
    gltf["bufferViews"].append(new_bv)
    gltf["images"][img_index]["bufferView"] = len(gltf["bufferViews"]) - 1
    gltf["images"][img_index]["mimeType"] = "image/png"
    del old_bv_idx  # old bytes stay as dead space; correctness over compaction
    gltf["buffers"][0]["byteLength"] = len(_pad4(blob))

    Path(dst_path).write_bytes(_build_glb(gltf, blob))
