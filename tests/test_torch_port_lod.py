"""The port's mesh processing and LOD chain against the JAX package.

Every wrapper of ``worldrenderer_tpu_torch.meshproc`` (the port's own copy
of the native library, built with g++ into the package's ``_build/``)
against the JAX package's on the inputs of ``tests/test_meshproc.py``;
``build_lod_chain`` and ``select_lod_level`` on the cases of
``tests/test_lod.py``; and a decimated level rendered by the port on the
CPU. numpy and torch run on one thread."""

import hashlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu as wr
from worldrenderer_tpu import meshproc as jmp
from worldrenderer_tpu.mesh import icosphere, make_grid_mesh, uv_sphere_mesh

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch import meshproc as pmp
from worldrenderer_tpu_torch.scene import gltf as pgltf


@pytest.fixture
def one_torch_thread():
    """Torch on one thread: beside other test processes on the same cores,
    the intra-op threads of the plain versions would wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _torus():
    nu, nv = 48, 24
    us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    v = np.array([[(1 + 0.4 * np.cos(b)) * np.cos(a),
                   (1 + 0.4 * np.cos(b)) * np.sin(a), 0.4 * np.sin(b)]
                  for a in us for b in vs])
    f = []
    for i in range(nu):
        for j in range(nv):
            a0, b0 = i * nv + j, ((i + 1) % nu) * nv + j
            c0, d0 = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
            f += [[a0, b0, c0], [a0, c0, d0]]
    return v, np.array(f)


def _cases():
    rng = np.random.default_rng(0)
    v1, f1 = icosphere(2)
    v2, f2 = icosphere(0)
    two = (np.concatenate([v1, v2 * 0.1 + 5.0]),
           np.concatenate([f1, f2 + len(v1)]))
    v3, f3 = icosphere(3)
    holed = icosphere(2)
    bad_v = np.concatenate([holed[0], [[0.0, 0.0, 1.5]]])
    bad_f = np.concatenate([holed[1][:-4], [[holed[1][0][0], holed[1][0][1],
                                             len(bad_v) - 1]]])
    verts, faces, uvs = uv_sphere_mesh(33, 65)
    weld = (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1.0000001, 0, 0],
                      [0, 0, 1]], np.float64), np.array([[0, 1, 2], [3, 4, 2]]))
    fan = (np.array([[0, 0, 0], [1, 0, 0], [0.5, 1, 0], [0.5, -1, 0],
                     [0.5, 0, 0.2]], np.float64),
           np.array([[0, 1, 2], [0, 1, 3], [0, 1, 4]]))
    bowtie = (np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 0, 0],
                        [-1, -1, 0]], np.float64), np.array([[0, 1, 2], [0, 3, 4]]))
    return {
        "weld_vertices": (weld, dict(threshold=1e-3)),
        "remove_small_components": (two, dict(min_faces=100)),
        "fill_holes": ((holed[0], holed[1][:-6]), dict(max_hole_size=30)),
        "taubin_smooth": ((v3 + rng.normal(0, 0.01, v3.shape), f3),
                          dict(steps=10)),
        "decimate": (icosphere(4), dict(target_faces=500)),
        "repair_non_manifold": (fan, {}),
        "repair_non_manifold:bowtie": (bowtie, dict(vertdispratio=0.1)),
        "decimate_with_texture": ((verts, uvs, faces), dict(target_faces=1000)),
        "process_mesh": ((v3, f3), dict(targetfacenum=400, maxholesize=30,
                                        stepsmoothnum=2)),
        "process_mesh:non_manifold": ((bad_v, bad_f), dict(
            targetfacenum=10**9, stepsmoothnum=0)),
        "uv_parameterize_uvatlas": (icosphere(2), dict(size=512)),
        "uv_parameterize_uvatlas:torus": (_torus(), dict(max_stretch=1 / 6)),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_meshproc_wrappers_match_jax(name):
    args, kw = CASES[name]
    fn = name.split(":")[0]
    got = getattr(pmp, fn)(*args, **kw)
    want = getattr(jmp, fn)(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if fn == "uv_parameterize_uvatlas":
        assert pmp.last_atlas_stretch() == jmp.last_atlas_stretch()
        assert pmp.last_atlas_stretch() <= 1.0 / (1.0 - 1.0 / 6.0) + 1e-6


def test_meshproc_builds_its_own_library_and_process_raw(tmp_path):
    assert pmp.native_available()
    lib = pmp._target()
    assert lib.parent.name == "_build" and lib.parent.parent.name == \
        "worldrenderer_tpu_torch" and lib.is_file()
    # A copy of the JAX package's source, never its library.
    assert pmp._SRC.read_bytes() == Path(jmp._SRC).read_bytes()
    assert pmp._SRC != Path(jmp._SRC)
    v, f = make_grid_mesh(10, height_fn=lambda x, y: 0.1 * x * y)
    src = tmp_path / "in.glb"
    pgltf.save_glb(src, v.astype(np.float32), f.astype(np.uint32))
    for mod, name in ((pmp, "port.glb"), (jmp, "jax.glb")):
        mod.process_raw(str(src), str(tmp_path / name), preprocess=False)
    got, want = (pgltf.load_glb(tmp_path / n) for n in ("port.glb", "jax.glb"))
    for k in ("vertices", "faces", "uv", "normals", "texture"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["faces"]) == len(f)


def test_meshproc_library_without_contraction():
    """``_get_lib(NO_CONTRACT)`` is a second build of the same source, keyed
    by its flags, and ``decimate(lib=...)`` runs on it. Without FMA
    contraction the decimation does IEEE operations in source order only,
    so its result is the same on every x86-64 host: pinned here."""
    lib = pmp._get_lib(pmp.NO_CONTRACT)
    assert pmp._target(pmp.NO_CONTRACT) != pmp._target()
    assert pmp._target(pmp.NO_CONTRACT).is_file() and lib is not pmp._get_lib()
    v, f = make_grid_mesh(80, height_fn=lambda x, y: 0.2 * x * y * x - 0.1 * y * y)
    dv, df = pmp.decimate(v, f, len(f) // 16, lib=lib)
    digest = hashlib.sha256(dv.tobytes() + df.tobytes()).hexdigest()[:12]
    assert (len(df), digest) == (780, "4e74d9aaade4")


@pytest.fixture(scope="module")
def bumpy():
    verts, faces = make_grid_mesh(
        100, extent=1.0,
        height_fn=lambda x, y: 0.2 * np.sin(4 * x) * np.cos(4 * y))
    return verts.astype(np.float32), faces.astype(np.int32)


@pytest.fixture(scope="module")
def chains(bumpy):
    verts, faces = bumpy
    jm = wr.TexturedMesh(v_pos=jnp.asarray(verts), t_pos_idx=jnp.asarray(faces))
    pm = pt.mesh_from_arrays(verts, faces, device="cpu")
    return (wr.build_lod_chain(jm, factors=(1, 4, 16)),
            pt.build_lod_chain(pm, factors=(1, 4, 16), device="cpu"))


def test_lod_chain_levels_match_jax(chains):
    jc, pc = chains
    assert len(pc) == len(jc) == 3 and pc.factors == jc.factors == (1, 4, 16)
    for a, b in zip(pc.levels, jc.levels):
        np.testing.assert_array_equal(_np(a.v_pos), _np(b.v_pos))
        np.testing.assert_array_equal(_np(a.t_pos_idx), _np(b.t_pos_idx))
        assert a.t_pos_idx.dtype == torch.int64 and a.v_pos.device.type == "cpu"
    for x, y in zip(pc.bbox, jc.bbox):
        np.testing.assert_array_equal(x, y)
    t = pc.levels[0].num_faces
    assert pc.levels[1].num_faces <= t // 4 + 64
    assert pc.levels[2].num_faces <= t // 16 + 64


def test_lod_level_selection_matches_jax(chains):
    jc, pc = chains
    views = [dict(elevation_deg=30.0, distance=d, fovy_deg=50.0, num_views=1,
                  near=0.1, far=50.0) for d in (2.0, 6.0, 12.0, 30.0)]
    for kw in views:
        for size in (128, 512, 1024):
            for target in (0.5, 2.0, 8.0):
                want = wr.select_lod_level(jc, wr.get_camera(**kw), size, size,
                                           target_px_per_tri=target)
                cam = pt.get_camera(**kw, device="cpu")
                assert pc.select(cam, size, size, target_px_per_tri=target) \
                    == want
    near = pt.get_camera(**views[0], device="cpu")
    far = pt.get_camera(**views[-1], device="cpu")
    assert pt.select_lod_level(pc, near, 1024, 1024) == 0
    assert pt.select_lod_level(pc, far, 128, 128) == len(pc) - 1
    both = pt.camera_from_arrays(
        *(np.concatenate([_np(getattr(near, f)), _np(getattr(far, f))])
          for f in ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")),
        device="cpu")
    assert pt.select_lod_level(pc, both, 1024, 1024) == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pc.mesh_for(far, 128, 128)  # the card unless the CPU is asked for
    assert pc.mesh_for(far, 128, 128, device="cpu") is not None


def test_decimated_level_renders(chains, one_torch_thread):
    _, pc = chains
    cam = pt.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                        num_views=1, near=0.1, far=10.0, device="cpu")
    a = pt.render(pc.levels[0], cam, 128, 128, render_attr=False, device="cpu")
    b = pt.render(pc.levels[-1], cam, 128, 128, render_attr=False, device="cpu")
    ca, cb = float(a.mask.float().mean()), float(b.mask.float().mean())
    assert ca > 0.2 and abs(ca - cb) < 0.03 * ca, (ca, cb)
    assert torch.isfinite(b.normal).all()


def test_textured_chain_matches_jax():
    verts, faces, uv = uv_sphere_mesh(33, 65)
    tex = np.zeros((64, 64, 3), np.float32)
    jm = wr.TexturedMesh(v_pos=jnp.asarray(verts, jnp.float32),
                         t_pos_idx=jnp.asarray(faces, jnp.int32),
                         v_tex=jnp.asarray(uv, jnp.float32),
                         t_tex_idx=jnp.asarray(faces, jnp.int32),
                         texture=jnp.asarray(tex))
    pm = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                             texture=tex, device="cpu")
    jc = wr.build_lod_chain(jm, factors=(1, 4))
    pc = pt.build_lod_chain(pm, factors=(1, 4), device="cpu")
    a, b = pc.levels[1], jc.levels[1]
    for f in ("v_pos", "t_pos_idx", "v_tex", "t_tex_idx", "texture"):
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)),
                                      err_msg=f)
    assert float(a.v_tex.min()) >= -1e-5 and float(a.v_tex.max()) <= 1 + 1e-5
    assert a.num_faces <= pm.num_faces // 4 + 64
