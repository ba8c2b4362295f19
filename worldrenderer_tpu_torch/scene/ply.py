"""Dependency-free PLY mesh reader (ASCII + binary little/big-endian), a
copy of ``worldrenderer_tpu/scene/ply.py`` for the PyTorch port.

Completes loader parity with the reference's trimesh-based ``load_mesh``
(mvadapter/utils/mesh_utils/mesh.py:198-345), which accepts anything
trimesh can read — .ply being the common third format after .glb/.obj.

Supports the standard Stanford PLY layout: a ``vertex`` element with
float properties (x, y, z required; nx/ny/nz, s/t or u/v texture coords,
red/green/blue vertex colors recognized) and a ``face`` element with a
``vertex_indices``/``vertex_index`` list property.  Polygons are
fan-triangulated.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["load_ply"]

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(data: bytes):
    """Returns (fmt, elements, header_len). elements is a list of
    (name, count, props) where props is a list of either ("list", count_dt,
    item_dt, name) or (dt, name)."""
    end = data.find(b"end_header\n")
    if end < 0 or not data.startswith(b"ply"):
        raise ValueError("not a PLY file")
    header_len = end + len(b"end_header\n")
    lines = data[:end].decode("ascii", "replace").splitlines()
    fmt = None
    elements = []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(
                    ("list", _PLY_DTYPES[parts[2]], _PLY_DTYPES[parts[3]], parts[4])
                )
            else:
                elements[-1][2].append((_PLY_DTYPES[parts[1]], parts[2]))
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r}")
    return fmt, elements, header_len


def _read_ascii(tokens, elements):
    out = {}
    it = iter(tokens)
    for name, count, props in elements:
        rows = []
        for _ in range(count):
            row = {}
            for p in props:
                if p[0] == "list":
                    n = int(next(it))
                    row[p[3]] = [float(next(it)) for _ in range(n)]
                else:
                    row[p[1]] = float(next(it))
            rows.append(row)
        out[name] = rows
    return out


def _read_binary(data: bytes, elements, little: bool):
    bo = "<" if little else ">"
    out = {}
    off = 0
    for name, count, props in elements:
        has_list = any(p[0] == "list" for p in props)
        if not has_list:
            dt = np.dtype([(p[1], bo + p[0]) for p in props])
            arr = np.frombuffer(data, dtype=dt, count=count, offset=off)
            off += dt.itemsize * count
            out[name] = arr
        else:
            rows = []
            for _ in range(count):
                row = {}
                for p in props:
                    if p[0] == "list":
                        cdt = np.dtype(bo + p[1])
                        n = int(np.frombuffer(data, cdt, 1, off)[0])
                        off += cdt.itemsize
                        idt = np.dtype(bo + p[2])
                        row[p[3]] = np.frombuffer(data, idt, n, off).tolist()
                        off += idt.itemsize * n
                    else:
                        dt = np.dtype(bo + p[0])
                        row[p[1]] = float(np.frombuffer(data, dt, 1, off)[0])
                        off += dt.itemsize
                rows.append(row)
            out[name] = rows
    return out


def load_ply(path) -> dict:
    """Load a .ply mesh. Returns the same dict shape as
    :func:`.gltf.load_glb`: vertices (V, 3) f64,
    faces (T, 3) i64, uv (V, 2) f32 or None, normals (V, 3) or None,
    texture None."""
    data = Path(path).read_bytes()
    fmt, elements, header_len = _parse_header(data)
    body = data[header_len:]

    if fmt == "ascii":
        parsed = _read_ascii(body.decode("ascii").split(), elements)
    else:
        parsed = _read_binary(body, elements, fmt == "binary_little_endian")

    if "vertex" not in parsed:
        raise ValueError(f"{path}: no vertex element")
    vert = parsed["vertex"]

    def col(names) -> Optional[np.ndarray]:
        if isinstance(vert, np.ndarray):
            fields = vert.dtype.names
            if all(n in fields for n in names):
                return np.stack(
                    [vert[n].astype(np.float64) for n in names], axis=-1
                )
            return None
        if all(n in vert[0] for n in names):
            return np.array([[r[n] for n in names] for r in vert], np.float64)
        return None

    vertices = col(("x", "y", "z"))
    if vertices is None:
        raise ValueError(f"{path}: vertex element lacks x/y/z")
    normals = col(("nx", "ny", "nz"))
    uv = col(("s", "t"))
    if uv is None:
        uv = col(("u", "v"))

    faces = []
    for row in parsed.get("face", []):
        idx = row.get("vertex_indices", row.get("vertex_index"))
        if idx is None:
            continue
        for k in range(1, len(idx) - 1):  # fan-triangulate polygons
            faces.append((idx[0], idx[k], idx[k + 1]))
    faces = np.asarray(faces, np.int64).reshape(-1, 3)

    return {
        "vertices": vertices,
        "faces": faces,
        "uv": None if uv is None else uv.astype(np.float32),
        "normals": normals,
        "texture": None,
    }
