"""TexturedMesh, vertex normals and tangents, the split-UV seam cut, the
quantized-texture registry, host mesh IO (``load_mesh``: GLB / glTF, OBJ,
PLY, NPZ) and procedural meshes (PyTorch counterpart of
``worldrenderer_tpu/mesh.py``)."""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .camera import normalize
from .transforms import cross, dot

__all__ = [
    "TexturedMesh",
    "compute_vertex_normals",
    "compute_vertex_tangents",
    "with_normals",
    "load_mesh",
    "merge_duplicate_vertices",
    "is_watertight",
    "mesh_use_texture",
    "unify_mesh_uv",
    "register_quantized_texture",
    "is_registered_quantized_texture",
    "icosphere",
    "make_grid_mesh",
    "uv_sphere_mesh",
]


def mesh_use_texture(mesh: "TexturedMesh", texture) -> "TexturedMesh":
    """The mesh with its texture swapped (a new tuple; nothing to
    restore)."""
    return mesh._replace(texture=texture)


class TexturedMesh(NamedTuple):
    """v_pos (V, 3) float32; t_pos_idx (T, 3) int64. Optional UVs
    (v_tex, t_tex_idx), texture image (H, W, C), stitched topology for
    smooth normals, and per-vertex normals / tangents."""

    v_pos: torch.Tensor
    t_pos_idx: torch.Tensor
    v_tex: Optional[torch.Tensor] = None
    t_tex_idx: Optional[torch.Tensor] = None
    texture: Optional[torch.Tensor] = None
    stitched_v_pos: Optional[torch.Tensor] = None
    stitched_t_pos_idx: Optional[torch.Tensor] = None
    v_nrm: Optional[torch.Tensor] = None
    v_tang: Optional[torch.Tensor] = None

    @property
    def num_vertices(self) -> int:
        return self.v_pos.shape[0]

    @property
    def num_faces(self) -> int:
        return self.t_pos_idx.shape[0]

    @property
    def uv_size(self) -> Optional[int]:
        return None if self.texture is None else self.texture.shape[0]

    def to(self, device: DeviceLike) -> "TexturedMesh":
        return TexturedMesh(*(None if a is None else a.to(device) for a in self))


# The JAX package's incidence-table degree cap (a scatter-add in corner
# order above it) and XLA's CPU tree-reduction window.
_TABLE_MAX_DEGREE = 64
_REDUCE_WINDOW = 32


def _sum_to_vertices(vals: torch.Tensor, t_pos_idx: torch.Tensor, n: int) -> torch.Tensor:
    """Per-face rows (T, C) summed onto the faces' three vertices -> (n, C).

    Each vertex's terms are taken in the order of the corner list [corner
    0 of every face, then corner 1, then corner 2] and added one at a time,
    as the JAX package's op-by-op run adds them. Where the largest degree D
    is over 32 and at most 64, that run sums its (V, D) table in two
    windows of 32 with the 64 - D padding split evenly before and after, so
    the first 32 - (64 - D) // 2 terms and the rest are summed apart and
    then added. On the card ``index_add_`` adds with atomics, in an order
    that changes from run to run; this fixed order gives the same bits on
    every device and run."""
    idx = t_pos_idx.T.reshape(-1)  # (3T,) corner-major
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    s_idx = idx[order]
    rank = torch.arange(idx.numel(), device=idx.device) - starts[s_idx]
    width = int(counts.max()) if n else 0
    table = vals.new_zeros((n, width, vals.shape[1]))
    table[s_idx, rank] = vals.repeat(3, 1)[order]

    def run(lo, hi):
        out = vals.new_zeros((n, vals.shape[1]))
        for k in range(lo, hi):
            out += table[:, k]  # adding a padding zero leaves a sum unchanged
        return out

    if _REDUCE_WINDOW < width <= _TABLE_MAX_DEGREE:
        first = _REDUCE_WINDOW - (2 * _REDUCE_WINDOW - width) // 2
        return run(0, first) + run(first, width)
    return run(0, width)


def compute_vertex_normals(v_pos: torch.Tensor, t_pos_idx: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals: face normals (:func:`cross`) summed
    onto their three vertices in a fixed order (the JAX package's segment
    sum), then normalized (:func:`normalize`): the JAX package's op-by-op
    bits on every device."""
    i0, i1, i2 = t_pos_idx[:, 0], t_pos_idx[:, 1], t_pos_idx[:, 2]
    v0, v1, v2 = v_pos[i0], v_pos[i1], v_pos[i2]
    face_normals = cross(v1 - v0, v2 - v0)  # (T, 3)
    v_nrm = _sum_to_vertices(face_normals, t_pos_idx, v_pos.shape[0])
    up = torch.tensor([0.0, 0.0, 1.0], dtype=v_nrm.dtype, device=v_nrm.device)
    v_nrm = torch.where(dot(v_nrm, v_nrm) > 1e-20, v_nrm, up)
    return normalize(v_nrm)


def compute_vertex_tangents(
    v_pos: torch.Tensor,
    t_pos_idx: torch.Tensor,
    v_tex: torch.Tensor,
    t_tex_idx: torch.Tensor,
    v_nrm: torch.Tensor,
) -> torch.Tensor:
    """Per-vertex tangents from UV-space edges: each face's tangent summed
    onto its vertices in a fixed order, averaged over the vertex's corner
    count, normalized and made orthogonal to ``v_nrm``."""
    pos = [v_pos[t_pos_idx[:, i]] for i in range(3)]
    tex = [v_tex[t_tex_idx[:, i]] for i in range(3)]
    uve1 = tex[1] - tex[0]
    uve2 = tex[2] - tex[0]
    pe1 = pos[1] - pos[0]
    pe2 = pos[2] - pos[0]
    nom = pe1 * uve2[..., 1:2] - pe2 * uve1[..., 1:2]
    denom = uve1[..., 0:1] * uve2[..., 1:2] - uve1[..., 1:2] * uve2[..., 0:1]
    denom_safe = torch.where(denom > 0.0, torch.clamp(denom, min=1e-6),
                             torch.clamp(denom, max=-1e-6))
    tang = nom / denom_safe  # (T, 3)

    n = v_pos.shape[0]
    tangents = _sum_to_vertices(tang, t_pos_idx, n)
    tansum = torch.bincount(t_pos_idx.reshape(-1), minlength=n).to(tang.dtype)
    tangents = tangents / torch.clamp(tansum, min=1.0)[:, None]
    tangents = normalize(tangents)
    return normalize(tangents - dot(tangents, v_nrm) * v_nrm)


def with_normals(mesh: TexturedMesh, compute_tangents: bool = False) -> TexturedMesh:
    """The mesh with v_nrm filled in, computed on the stitched topology,
    and with ``compute_tangents`` v_tang (on the primary topology)."""
    if mesh.stitched_v_pos is None or mesh.stitched_t_pos_idx is None:
        mesh = mesh._replace(
            stitched_v_pos=mesh.v_pos, stitched_t_pos_idx=mesh.t_pos_idx
        )
    if mesh.v_nrm is None:
        mesh = mesh._replace(
            v_nrm=compute_vertex_normals(
                mesh.stitched_v_pos, mesh.stitched_t_pos_idx
            )
        )
    if compute_tangents and mesh.v_tang is None:
        v_nrm = mesh.v_nrm
        if v_nrm.shape[0] != mesh.v_pos.shape[0]:
            v_nrm = compute_vertex_normals(mesh.v_pos, mesh.t_pos_idx)
        mesh = mesh._replace(v_tang=compute_vertex_tangents(
            mesh.v_pos, mesh.t_pos_idx, mesh.v_tex, mesh.t_tex_idx, v_nrm))
    return mesh


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def unify_mesh_uv(mesh: TexturedMesh) -> TexturedMesh:
    """Seam-cut a split-UV mesh into unified per-vertex-UV indexing, so it
    takes the fused branch of ``render``: one output vertex per unique
    (pos_idx, tex_idx) corner pair, faces in their order. Normals (and
    tangents) come from the original position topology, where faces across
    a seam still share vertices, so shading stays smooth across seams; the
    unified topology is then its own stitched topology.

    The indices are read on the host (a copy from the card for a CUDA mesh)
    and the result lies on the mesh's device. Meshes already unified are
    returned unchanged."""
    if mesh.v_tex is None or mesh.t_tex_idx is None:
        return mesh
    pos_idx = _host(mesh.t_pos_idx).astype(np.int64)
    tex_idx = _host(mesh.t_tex_idx).astype(np.int64)
    if mesh.v_tex.shape[0] == mesh.v_pos.shape[0] and np.array_equal(
            pos_idx, tex_idx):
        return mesh
    dev = mesh.v_pos.device
    key = pos_idx.reshape(-1) << 32 | tex_idx.reshape(-1)
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    src_pos = torch.from_numpy(pos_idx.reshape(-1)[first]).to(dev)
    src_tex = torch.from_numpy(tex_idx.reshape(-1)[first]).to(dev)
    faces = torch.from_numpy(inverse.reshape(-1, 3).astype(np.int64)).to(dev)

    v_nrm = mesh.v_nrm
    if v_nrm is None or v_nrm.shape[0] != mesh.v_pos.shape[0]:
        v_nrm = compute_vertex_normals(mesh.v_pos, mesh.t_pos_idx)
    v_tang = None
    if mesh.v_tang is not None and mesh.v_tang.shape[0] == mesh.v_pos.shape[0]:
        v_tang = mesh.v_tang[src_pos]
    u_pos = mesh.v_pos[src_pos].float()
    return TexturedMesh(
        v_pos=u_pos, t_pos_idx=faces, v_tex=mesh.v_tex[src_tex].float(),
        t_tex_idx=faces, texture=mesh.texture, stitched_v_pos=u_pos,
        stitched_t_pos_idx=faces, v_nrm=v_nrm[src_pos], v_tang=v_tang,
    )


class _WeakCache:
    """At most ``cap`` entries keyed by the identity of a few objects and
    held through weak references: an entry goes when any of its objects is
    collected, so neither a key's object nor a recycled id outlives it."""

    def __init__(self, cap: int):
        self.cap = cap
        self.entries: dict = {}

    def get(self, objs):
        hit = self.entries.get(tuple(map(id, objs)))
        if hit is None or any(r() is not o for r, o in zip(hit[0], objs)):
            return None
        return hit[1]

    def put(self, objs, value) -> None:
        key = tuple(map(id, objs))

        def drop(_, key=key):
            entry = self.entries.get(key)
            if entry is not None and any(r() is None for r in entry[0]):
                del self.entries[key]

        if key not in self.entries and len(self.entries) >= self.cap:
            self.entries.pop(next(iter(self.entries)))
        self.entries[key] = (tuple(weakref.ref(o, drop) for o in objs), value)


# render()'s on-the-fly seam cut, keyed by the caller's mesh tensors (taken
# before render moves the mesh to its device, which would make new ones).
_UNIFY_CACHE = _WeakCache(8)
# Textures whose 255-quantization the caller established on the host, so
# render's texture_pack_mode="auto" never copies a card tensor back.
_QUANT_TEX_CACHE = _WeakCache(16)


def _unify_cached(mesh: TexturedMesh) -> TexturedMesh:
    keys = [a for a in (mesh.v_pos, mesh.v_tex, mesh.t_pos_idx,
                        mesh.t_tex_idx, mesh.v_nrm) if a is not None]
    hit = _UNIFY_CACHE.get(keys)
    if hit is None:
        hit = unify_mesh_uv(mesh)._replace(texture=None)
        _UNIFY_CACHE.put(keys, hit)
    return hit._replace(texture=mesh.texture)


def register_quantized_texture(arr: torch.Tensor) -> None:
    """Mark a texture tensor (usually on the card) as exactly
    255-quantized; the caller verified that on the host-side source. The
    mark goes when the tensor is collected."""
    _QUANT_TEX_CACHE.put([arr], True)


def is_registered_quantized_texture(arr) -> bool:
    return _QUANT_TEX_CACHE.get([arr]) is not None


# ---------------------------------------------------------------------------
# Host mesh IO (numpy): files are parsed and converted on the host, then the
# tensors move to the device, so a loaded mesh has the same bits everywhere.
# ---------------------------------------------------------------------------


def merge_duplicate_vertices(
    vertices: np.ndarray, faces: np.ndarray, decimals: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge positionally identical vertices (rounded to ``decimals``) into
    the stitched topology used for smooth normals. numpy in, numpy out."""
    key = np.round(np.asarray(vertices, np.float64), decimals)
    _, first_idx, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    merged_vertices = np.asarray(vertices)[first_idx]
    merged_faces = inverse.reshape(-1)[np.asarray(faces)]
    return merged_vertices, merged_faces


def is_watertight(faces, n_vertices: Optional[int] = None) -> bool:
    """True when a triangle topology is closed, manifold and consistently
    wound: every undirected edge is shared by exactly two faces that
    traverse it in opposite directions. For such a mesh seen from outside,
    every back face is hidden by a nearer front face, so
    ``RasterizerConfig.backface_cull`` changes no pixel. ``faces`` (T, 3)
    array or tensor (read on the host)."""
    if isinstance(faces, torch.Tensor):
        faces = _host(faces)
    f = np.asarray(faces)
    if f.size == 0:
        return False
    # A face with a repeated vertex makes a self-loop edge (a -> a), its
    # own reverse, which would fool the pairing test below.
    if (
        (f[:, 0] == f[:, 1]) | (f[:, 1] == f[:, 2]) | (f[:, 0] == f[:, 2])
    ).any():
        return False
    a = f
    b = f[:, [1, 2, 0]]
    n = int(n_vertices) if n_vertices is not None else int(f.max()) + 1
    d = (a.astype(np.int64) * n + b.astype(np.int64)).reshape(-1)
    # Closed, consistently wound 2-manifold <=> each directed edge occurs
    # exactly once and so does its reverse.
    if len(np.unique(d)) != d.size:
        return False
    rev = (b.astype(np.int64) * n + a.astype(np.int64)).reshape(-1)
    return bool(np.isin(d, rev).all())


def _load_obj(path: str):
    """Minimal OBJ parser: v / vt / vn / f records, polygons triangulated as
    fans. Returns (vertices f64, faces i64, uv or None, normals or None),
    one vertex per unique (v, vt, vn) corner triple (the unstitched layout
    GLB files use)."""
    positions, texcoords, normals = [], [], []
    corner_map = {}
    out_pos, out_uv, out_nrm, faces = [], [], [], []

    def corner(spec: str) -> int:
        if spec in corner_map:
            return corner_map[spec]
        parts = (spec.split("/") + ["", ""])[:3]
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        out_pos.append(positions[vi])
        if parts[1]:
            ti = int(parts[1])
            out_uv.append(texcoords[ti - 1 if ti > 0 else len(texcoords) + ti])
        if parts[2]:
            ni = int(parts[2])
            out_nrm.append(normals[ni - 1 if ni > 0 else len(normals) + ni])
        corner_map[spec] = len(out_pos) - 1
        return corner_map[spec]

    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                positions.append([float(x) for x in t[1:4]])
            elif t[0] == "vt":
                texcoords.append([float(x) for x in t[1:3]])
            elif t[0] == "vn":
                normals.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                ids = [corner(s) for s in t[1:]]
                for k in range(1, len(ids) - 1):
                    faces.append([ids[0], ids[k], ids[k + 1]])

    verts = np.asarray(out_pos, np.float64)
    uv = np.asarray(out_uv, np.float64) if len(out_uv) == len(out_pos) else None
    nrm = np.asarray(out_nrm, np.float64) if len(out_nrm) == len(out_pos) else None
    return verts, np.asarray(faces, np.int64), uv, nrm


_DIR2VEC = {
    "+x": np.array([1, 0, 0]),
    "+y": np.array([0, 1, 0]),
    "+z": np.array([0, 0, 1]),
    "-x": np.array([-1, 0, 0]),
    "-y": np.array([0, -1, 0]),
    "-z": np.array([0, 0, -1]),
}


def load_mesh(
    mesh_path: str,
    rescale: bool = False,
    move_to_center: bool = False,
    scale: float = 0.5,
    flip_uv: bool = True,
    merge_vertices: bool = True,
    default_uv_size: Optional[int] = None,
    shape_init_mesh_up: str = "+y",
    shape_init_mesh_front: str = "+x",
    front_x_to_y: bool = False,
    return_transform: bool = False,
    device: DeviceLike = None,
):
    """Load a mesh from GLB / glTF-JSON / OBJ / PLY / NPZ into a
    TexturedMesh on ``device`` (the card unless ``device="cpu"``).

    The file is parsed and converted to float32 / int64 on the host:
    scene concatenation (a multi-material GLB becomes one strip-atlas
    texture), recentring and rescaling, the up / front change of basis,
    the UV V-flip, the baseColor texture, and the stitched topology for
    smooth normals (the file's normals, else merged duplicate vertices).
    A texture decoded from an image file is k/255 by construction; checked
    on the host, it is registered with :func:`register_quantized_texture`
    so ``render``'s pack auto-detection never reads it back from the card.
    ``return_transform``: also return the centring offset and the scale
    divisor (None where not applied)."""
    dev = resolve_device(device)
    vertex_normals = None
    visual_uv = None
    tex_img = None
    can_merge = False
    if mesh_path.endswith(".npz"):
        data = np.load(mesh_path)
        vertices = np.asarray(data["vertices"], np.float64)
        faces = np.asarray(data["faces"], np.int64)
        visual_uv = np.asarray(data["uv"], np.float64) if "uv" in data else None
        merge_vertices = False
    elif mesh_path.endswith((".glb", ".gltf")):
        from .scene.gltf import load_glb

        parsed = load_glb(mesh_path)
        vertices = parsed["vertices"]
        faces = parsed["faces"]
        visual_uv = parsed["uv"]
        if parsed["normals"] is not None:
            vertex_normals = np.asarray(parsed["normals"], np.float64)
        if parsed["texture"] is not None and default_uv_size is None:
            tex_img = parsed["texture"][..., :3]
        can_merge = True
    elif mesh_path.endswith(".obj"):
        vertices, faces, visual_uv, vertex_normals = _load_obj(mesh_path)
        can_merge = True
    elif mesh_path.endswith(".ply"):
        from .scene.ply import load_ply

        parsed = load_ply(mesh_path)
        vertices = parsed["vertices"]
        faces = parsed["faces"]
        visual_uv = parsed["uv"]
        if parsed["normals"] is not None:
            vertex_normals = np.asarray(parsed["normals"], np.float64)
        can_merge = True
    else:
        raise ValueError(f"Unsupported mesh format: {mesh_path}")

    transform_offset = None
    if move_to_center:
        transform_offset = vertices.mean(0)
        vertices = vertices - transform_offset

    transform_scale = None
    if rescale:
        max_scale = np.abs(vertices).max()
        vertices = vertices / max_scale * scale
        transform_scale = max_scale / scale

    if shape_init_mesh_up not in _DIR2VEC or shape_init_mesh_front not in _DIR2VEC:
        raise ValueError(f"up/front must be one of {list(_DIR2VEC)}")
    if shape_init_mesh_up[1] == shape_init_mesh_front[1]:
        raise ValueError("up and front axes must be orthogonal")
    z_ = _DIR2VEC[shape_init_mesh_up]
    x_ = _DIR2VEC[shape_init_mesh_front]
    y_ = np.cross(z_, x_)
    std2mesh = np.stack([x_, y_, z_], axis=0).T
    mesh2std = np.linalg.inv(std2mesh)
    vertices = (mesh2std @ vertices.T).T
    if vertex_normals is not None:
        vertex_normals = (mesh2std @ vertex_normals.T).T
    if front_x_to_y:
        x = vertices[:, 1].copy()
        y = -vertices[:, 0].copy()
        vertices[:, 0], vertices[:, 1] = x, y
        if vertex_normals is not None:
            vx = vertex_normals[:, 1].copy()
            vy = -vertex_normals[:, 0].copy()
            vertex_normals[:, 0], vertex_normals[:, 1] = vx, vy

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def i64(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    v_pos = f32(vertices)
    t_pos_idx = i64(faces)

    v_tex = t_tex_idx = texture = None
    if visual_uv is not None:
        uv = visual_uv.astype(np.float32)
        if flip_uv:
            uv[:, 1] = 1.0 - uv[:, 1]
        v_tex = f32(uv)
        t_tex_idx = t_pos_idx
        if tex_img is not None:
            texture = f32(tex_img)
            # Image-file textures are k/255 by construction; checked here on
            # the host copy before the tensor is registered.
            a = np.asarray(tex_img, np.float32)
            if a.size and a.min() >= 0.0 and a.max() <= 1.0:
                r = a * 255.0
                if np.abs(r - np.round(r)).max() <= 1e-4:
                    register_quantized_texture(texture)
        else:
            if default_uv_size is None:
                raise ValueError("a mesh without a texture needs default_uv_size")
            texture = torch.zeros((default_uv_size, default_uv_size, 3),
                                  dtype=torch.float32, device=dev)

    mesh = TexturedMesh(
        v_pos=v_pos, t_pos_idx=t_pos_idx, v_tex=v_tex, t_tex_idx=t_tex_idx,
        texture=texture,
    )

    if vertex_normals is not None:
        mesh = mesh._replace(
            v_nrm=f32(vertex_normals / np.maximum(
                np.linalg.norm(vertex_normals, axis=-1, keepdims=True), 1e-12)),
            stitched_v_pos=v_pos,
            stitched_t_pos_idx=t_pos_idx,
        )
    elif merge_vertices and can_merge:
        sv, sf = merge_duplicate_vertices(vertices, faces)
        mesh = mesh._replace(stitched_v_pos=f32(sv), stitched_t_pos_idx=i64(sf))
    else:
        mesh = mesh._replace(stitched_v_pos=v_pos, stitched_t_pos_idx=t_pos_idx)

    if return_transform:
        return mesh, transform_offset, transform_scale
    return mesh


# ---------------------------------------------------------------------------
# Procedural meshes (numpy, host side): test fixtures and benchmarks.
# ---------------------------------------------------------------------------


def icosphere(subdivisions: int = 2, radius: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere. Returns (vertices, faces)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m = m / np.linalg.norm(m)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(verts_list)
        faces = np.array(new_faces, dtype=np.int64)

    return verts * radius, faces


def make_grid_mesh(
    n: int, extent: float = 1.0, height_fn=None
) -> Tuple[np.ndarray, np.ndarray]:
    """(n x n)-vertex heightfield grid mesh in the XY plane.
    height_fn(x, y) -> z, default 0."""
    xs = np.linspace(-extent, extent, n)
    ys = np.linspace(-extent, extent, n)
    xx, yy = np.meshgrid(xs, ys, indexing="xy")
    zz = np.zeros_like(xx) if height_fn is None else height_fn(xx, yy)
    verts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    idx = np.arange(n * n).reshape(n, n)
    f0 = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1]], axis=-1)
    f1 = np.stack([idx[:-1, 1:], idx[1:, 1:], idx[1:, :-1]], axis=-1)
    faces = np.concatenate([f0.reshape(-1, 3), f1.reshape(-1, 3)], axis=0)
    return verts, faces.astype(np.int64)


def uv_sphere_mesh(
    n_lat: int, n_lon: int, radius: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """UV-parameterized sphere: (vertices, faces, uv), wound so
    cross(v1-v0, v2-v0) points outward."""
    lats = np.linspace(0, np.pi, n_lat)
    lons = np.linspace(0, 2 * np.pi, n_lon)
    ll, tt = np.meshgrid(lons, lats, indexing="xy")
    x = radius * np.sin(tt) * np.cos(ll)
    y = radius * np.sin(tt) * np.sin(ll)
    z = radius * np.cos(tt)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    uv = np.stack([ll / (2 * np.pi), tt / np.pi], axis=-1).reshape(-1, 2)
    idx = np.arange(n_lat * n_lon).reshape(n_lat, n_lon)
    f0 = np.stack([idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:]], axis=-1)
    f1 = np.stack([idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]], axis=-1)
    faces = np.concatenate([f0.reshape(-1, 3), f1.reshape(-1, 3)], axis=0)
    return verts, faces.astype(np.int64), uv
