"""Mesh processing on the host: welding, island removal, hole filling,
smoothing, QEM decimation (with and without a texture atlas), non-manifold
repair and UV-atlas parameterization (the PyTorch port's copy of
``worldrenderer_tpu/meshproc``).

The work is done by the port's own copy of the native library
(``native/meshproc.cpp``), compiled with g++ at first use into the
package's git-ignored ``_build/`` under a name keyed by a hash of the
source and the flags, and called through ctypes. The wrappers take and
return numpy arrays. A library that fails to build raises, with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "process_mesh",
    "uv_parameterize_uvatlas",
    "last_atlas_stretch",
    "process_raw",
    "weld_vertices",
    "remove_small_components",
    "fill_holes",
    "taubin_smooth",
    "decimate",
    "decimate_with_texture",
    "repair_non_manifold",
    "native_available",
]

_SRC = Path(__file__).resolve().parent / "native" / "meshproc.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# The JAX package's flags. -march=native: the library is built on, and for,
# the machine that loads it (_build/ is never committed). Where that machine
# has FMA, g++ contracts a*b + c into one rounding, so QEM costs, and with
# them a decimation's collapse order and face count, depend on the host;
# NO_CONTRACT builds the same source without contraction, as a host
# without FMA runs it.
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
NO_CONTRACT = GXX_FLAGS + ("-ffp-contract=off",)

_state: Dict[Tuple[str, ...], ctypes.CDLL] = {}


def _target(flags: Tuple[str, ...] = GXX_FLAGS) -> Path:
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(_SRC.read_bytes())
    return _BUILD_DIR / f"meshproc-{digest.hexdigest()[:16]}.so"


def _build(out: Path, flags: Tuple[str, ...] = GXX_FLAGS) -> None:
    """Compile the library to ``out`` through a temporary name, so that
    processes building at once never load a half-written file."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *flags, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"meshproc build failed: g++ exited {proc.returncode}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def _get_lib(flags: Tuple[str, ...] = GXX_FLAGS) -> ctypes.CDLL:
    """The library built with ``flags``, building it first if needed;
    raises if the build fails."""
    lib = _state.get(flags)
    if lib is not None:
        return lib
    out = _target(flags)
    if not out.exists():
        _build(out, flags)
    lib = ctypes.CDLL(str(out))
    c_d = ctypes.POINTER(ctypes.c_double)
    c_i = ctypes.POINTER(ctypes.c_int64)
    lib.meshproc_process.argtypes = [
        c_d, ctypes.c_int64, c_i, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.meshproc_result_nv.restype = ctypes.c_int64
    lib.meshproc_result_nf.restype = ctypes.c_int64
    lib.meshproc_result_nuv.restype = ctypes.c_int64
    lib.meshproc_result_nv_tex.restype = ctypes.c_int64
    lib.meshproc_atlas_stretch.restype = ctypes.c_double
    _state[flags] = lib
    return lib


def native_available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _get_lib() is not None


def _as_cptrs(vertices: np.ndarray, faces: np.ndarray):
    v = np.ascontiguousarray(vertices, np.float64)
    f = np.ascontiguousarray(faces, np.int64)
    return (
        v, f,
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(v)),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(f)),
    )


def _fetch_result(lib) -> Tuple[np.ndarray, np.ndarray]:
    nv = lib.meshproc_result_nv()
    nf = lib.meshproc_result_nf()
    verts = np.empty((nv, 3), np.float64)
    faces = np.empty((nf, 3), np.int64)
    lib.meshproc_get_result(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return verts, faces


def _native_op(name: str, vertices, faces, *args, lib=None):
    if lib is None:
        lib = _get_lib()
    v, f, vp, nv, fp, nf = _as_cptrs(vertices, faces)
    rc = getattr(lib, name)(vp, nv, fp, nf, *args)
    if rc != 0:
        raise RuntimeError(f"{name} failed with code {rc}")
    return _fetch_result(lib)


def weld_vertices(vertices, faces, threshold: float = 1e-4):
    """Merge vertices closer than ``threshold`` (absolute distance;
    reference merge_close_vertices uses a bbox-relative percentage — callers
    scale accordingly)."""
    return _native_op("meshproc_weld", vertices, faces, ctypes.c_double(threshold))


def remove_small_components(vertices, faces, min_faces: int):
    return _native_op(
        "meshproc_remove_small_components", vertices, faces,
        ctypes.c_int64(min_faces),
    )


def fill_holes(vertices, faces, max_hole_size: int = 30):
    return _native_op(
        "meshproc_fill_holes", vertices, faces, ctypes.c_int64(max_hole_size)
    )


def taubin_smooth(vertices, faces, steps: int = 3):
    return _native_op(
        "meshproc_taubin_smooth", vertices, faces, ctypes.c_int(steps)
    )


def decimate(vertices, faces, target_faces: int, lib=None):
    """Quadric-error-metric edge-collapse decimation
    (simplify_quadric_decimation analog); ``lib``: a library of
    :func:`_get_lib` other than the default build."""
    return _native_op(
        "meshproc_decimate", vertices, faces, ctypes.c_int64(target_faces),
        lib=lib,
    )


def repair_non_manifold(vertices, faces, vertdispratio: float = 0.1):
    """Repair non-manifold edges (drop smallest-area extra faces until every
    edge has <=2) and split bowtie vertices with a ``vertdispratio``
    displacement (reference meshing_repair_non_manifold_edges +
    meshing_repair_non_manifold_vertices, mesh_process.py:122-129)."""
    return _native_op(
        "meshproc_repair_non_manifold", vertices, faces,
        ctypes.c_double(vertdispratio),
    )


def decimate_with_texture(
    v_pos,
    v_tex,
    faces,
    target_faces: int,
    boundary_weight: float = 1000.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Texture-preserving QEM decimation (reference
    decimate_quadric_edge_collapse_with_texture, mesh_process.py:30-47).

    ``v_pos`` (N, 3) and ``v_tex`` (N, 2) share the UV-unified (seam-cut)
    indexing of ``faces`` — the representation ``process_raw`` exports.
    Collapse error lives in R^5 = (x, y, z, u*s, v*s) with s = bbox diagonal
    (commensurates a full texture-width UV error with a mesh-sized spatial
    error); UV seams are boundary edges in this indexing and get heavy
    line-constraint quadrics, so the atlas survives decimation. Returns
    (v_pos, v_tex, faces)."""
    lib = _get_lib()
    v_pos = np.ascontiguousarray(v_pos, np.float64)
    v_tex = np.ascontiguousarray(v_tex, np.float64)
    f = np.ascontiguousarray(faces, np.int64)
    diag = float(np.linalg.norm(v_pos.max(0) - v_pos.min(0)))
    s = diag if diag > 0 else 1.0
    v5 = np.concatenate([v_pos, v_tex * s], axis=1)
    v5 = np.ascontiguousarray(v5, np.float64)
    rc = lib.meshproc_decimate_textured(
        v5.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(v5)),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(f)),
        ctypes.c_int64(target_faces),
        ctypes.c_double(boundary_weight),
    )
    if rc != 0:
        raise RuntimeError(f"meshproc_decimate_textured failed with code {rc}")
    nv = lib.meshproc_result_nv_tex()
    nf = lib.meshproc_result_nf()
    out5 = np.empty((nv, 5), np.float64)
    out_f = np.empty((nf, 3), np.int64)
    lib.meshproc_get_result_tex(
        out5.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out5[:, :3], out5[:, 3:] / s, out_f


def _vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fn = np.cross(
        vertices[faces[:, 1]] - vertices[faces[:, 0]],
        vertices[faces[:, 2]] - vertices[faces[:, 0]],
    )
    n = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def process_mesh(
    vertices,
    faces,
    threshold: float = 0.0001,
    mincomponentRatio: float = 0.02,
    targetfacenum: int = 50000,
    maxholesize: int = 30,
    stepsmoothnum: int = 10,
    verbose: bool = False,
):
    """Full preprocessing chain (reference process_mesh mesh_process.py:168-220):
    weld -> island removal -> repair -> hole fill -> Taubin -> decimate ->
    Taubin -> repair -> normals. ``threshold`` is bbox-diagonal-relative
    (pymeshlab PercentageValue semantics)."""
    lib = _get_lib()
    vertices = np.ascontiguousarray(vertices, np.float64)
    faces = np.ascontiguousarray(faces, np.int64)
    diag = float(np.linalg.norm(vertices.max(0) - vertices.min(0)))
    abs_threshold = threshold * diag
    v, f, vp, nv, fp, nf = _as_cptrs(vertices, faces)
    rc = lib.meshproc_process(
        vp, nv, fp, nf,
        ctypes.c_double(abs_threshold),
        ctypes.c_double(mincomponentRatio),
        ctypes.c_int64(targetfacenum),
        ctypes.c_int64(maxholesize),
        ctypes.c_int(stepsmoothnum),
    )
    if rc != 0:
        raise RuntimeError(f"meshproc_process failed with code {rc}")
    out_v, out_f = _fetch_result(lib)
    if verbose:
        print(
            f"process_mesh: {len(vertices)}v/{len(faces)}f -> "
            f"{len(out_v)}v/{len(out_f)}f"
        )
    return out_v, out_f, _vertex_normals(out_v, out_f)


def uv_parameterize_uvatlas(
    vertices,
    faces,
    size: int = 1024,
    gutter: float = 2.5,
    max_stretch: float = 0.1666666716337204,
    parallel_partitions: int = 16,
    nthreads: int = 0,
) -> np.ndarray:
    """Per-face-corner UV parameterization (reference
    uv_parameterize_uvatlas mesh_process.py:224-252, open3d compute_uvatlas).
    Returns (#F, 3, 2). Charting is normal-clustered region growing with
    planar projection + shelf packing; ``gutter`` is in texels of ``size``.
    ``max_stretch`` (UVAtlas semantics, in [0,1]) bounds each chart's
    normalized L2 geometric stretch at 1/(1-max_stretch) — over-stretched
    charts are re-grown with tighter normal cones until they pass; the
    measured maximum is available via :func:`last_atlas_stretch`."""
    del parallel_partitions, nthreads  # parity args
    lib = _get_lib()
    v, f, vp, nv, fp, nf = _as_cptrs(vertices, faces)
    rc = lib.meshproc_uv_atlas(
        vp, nv, fp, nf,
        ctypes.c_double(gutter / float(size)),
        ctypes.c_double(0.7),
        ctypes.c_double(max_stretch),
    )
    if rc != 0:
        raise RuntimeError(f"meshproc_uv_atlas failed with code {rc}")
    n_uv = lib.meshproc_result_nuv()
    uv = np.empty((n_uv, 2), np.float64)
    lib.meshproc_get_uvs(uv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return uv.reshape(-1, 3, 2).astype(np.float32)


def last_atlas_stretch() -> float:
    """Measured maximum per-chart normalized L2 stretch of the most recent
    :func:`uv_parameterize_uvatlas` call (1.0 = isometric)."""
    lib = _get_lib()
    return float(lib.meshproc_atlas_stretch())


def process_raw(mesh_path: str, save_path: str, preprocess: bool = True) -> None:
    """Load -> (optional) preprocess -> UV unwrap -> hash-dedup UV vertices ->
    export GLB (reference process_raw mesh_process.py:256-349, including the
    uint64 (u<<32|v) UV hash dedup at mesh_process.py:302-332)."""
    from ..mesh import _load_obj
    from ..scene.gltf import load_glb, save_glb

    if mesh_path.endswith((".glb", ".gltf")):
        parsed = load_glb(mesh_path)
        vertices, faces = parsed["vertices"], parsed["faces"]
    elif mesh_path.endswith(".obj"):
        vertices, faces, _, _ = _load_obj(mesh_path)
    else:
        raise ValueError(f"unsupported mesh format: {mesh_path}")

    if preprocess:
        v_pos, t_pos_idx, normals = process_mesh(
            vertices, faces,
            mincomponentRatio=0.02, targetfacenum=50000,
            maxholesize=100, stepsmoothnum=10,
        )
    else:
        v_pos, t_pos_idx = np.asarray(vertices), np.asarray(faces)
        normals = _vertex_normals(v_pos, t_pos_idx)

    v_tex = uv_parameterize_uvatlas(v_pos, t_pos_idx).reshape(-1, 2).astype(np.float32)

    # Hash-based UV vertex dedup (reference mesh_process.py:302-332): corners
    # sharing the exact same UV collapse to one vertex.
    u_bits = v_tex[:, 0].view(np.uint32).astype(np.uint64)
    v_bits = v_tex[:, 1].view(np.uint32).astype(np.uint64)
    hashed = (u_bits << np.uint64(32)) | v_bits
    _, first_idx, inverse = np.unique(hashed, return_index=True, return_inverse=True)

    v_pos_f3 = v_pos[t_pos_idx].reshape(-1, 3)
    normals_f3 = normals[t_pos_idx].reshape(-1, 3)

    out_v = v_pos_f3[first_idx]
    out_n = normals_f3[first_idx]
    out_uv = v_tex[first_idx].copy()
    out_f = inverse.reshape(-1, 3)

    # Flip V for export (reference mesh_process.py:337-339).
    out_uv[:, 1] = 1.0 - out_uv[:, 1]

    save_glb(
        save_path,
        vertices=out_v.astype(np.float32),
        faces=out_f.astype(np.uint32),
        uv=out_uv,
        normals=out_n.astype(np.float32),
        texture=np.full((4, 4, 3), 0.5, np.float32),
    )
