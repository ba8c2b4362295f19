"""The multi-device paths of the PyTorch port against the JAX package on the
CPU: view-split renders over an 8-slot CPU mesh (the JAX side over
tests/conftest.py's 8 virtual devices), the texel-sharded bake, mesh
bucketing, the sweep runner with resume, the texture-fit step against
optax's Adam (also from a converted optax state), and a two-process gloo
group running the coordination calls and a data-parallel fit step.

Scenes are tests/test_parallel.py's. The JAX references run once per
module (cached in fixtures), as users run them (jitted); torch and numpy
run on one thread. Limits: G-buffer masks equal and attributes within 5e-4
(tests/test_gbuffer.py:35-65's attribute tolerance); the sharded bake against the JAX package's
at test_torch_port_bake.py's camera_projection limits (mask flips within
1e-3 of the chart's texels, values within 5e-4 where both are valid), and
bit for bit against the port's own unsharded bake."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

import worldrenderer_tpu as wr
from worldrenderer_tpu.baking.projection import camera_projection as j_projection
from worldrenderer_tpu.mesh import uv_sphere_mesh
from worldrenderer_tpu.parallel import make_device_mesh as j_make_mesh
from worldrenderer_tpu.parallel import runner as jrunner
from worldrenderer_tpu.parallel import sweep as jsweep

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch.baking.projection import camera_projection
from worldrenderer_tpu_torch.convert import adam_state_from_optax
from worldrenderer_tpu_torch.parallel import make_device_mesh, runner, sweep
from worldrenderer_tpu_torch.parallel.device_mesh import (replicated_sharding,
                                                          view_sharding)

RES = 64
FIT_RES = 32  # the fit tests' views
CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")
ROOT = Path(__file__).resolve().parents[1]


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


def _port_mesh(jm):
    return pt.mesh_from_arrays(_np(jm.v_pos), _np(jm.t_pos_idx),
                               v_tex=None if jm.v_tex is None else _np(jm.v_tex),
                               t_tex_idx=None if jm.t_tex_idx is None
                               else _np(jm.t_tex_idx),
                               texture=None if jm.texture is None
                               else _np(jm.texture), device="cpu")


def _cpu_mesh(n=8, axis="views"):
    return make_device_mesh(axis_names=(axis,), devices=["cpu"] * n)


@pytest.fixture(scope="module")
def small_scene():
    """tests/test_parallel.py:23-38: the 9 x 17 sphere with a 24² ramp
    texture and 8 views."""
    verts, faces, uv = uv_sphere_mesh(9, 17)
    tex = np.linspace(0, 1, 24 * 24 * 3, dtype=np.float32).reshape(24, 24, 3)
    jm = wr.TexturedMesh(v_pos=jnp.asarray(verts, jnp.float32),
                         t_pos_idx=jnp.asarray(faces, jnp.int32),
                         v_tex=jnp.asarray(uv, jnp.float32),
                         t_tex_idx=jnp.asarray(faces, jnp.int32),
                         texture=jnp.asarray(tex))
    jc = wr.get_camera(elevation_deg=15.0, distance=3.0, fovy_deg=45.0,
                       num_views=8, near=0.1, far=10.0)
    return dict(jm=jm, jc=jc, pm=_port_mesh(jm), pc=_port_cam(jc))


# ---- device meshes and view-split renders ------------------------------------


def test_device_mesh_shape_and_placements():
    """A mesh's shape maps axis names to sizes; view placements split rows
    in contiguous blocks, one per device along the axis, and refuse a count
    the axis does not divide; replicated placements name each device once."""
    dm = make_device_mesh((2, 4), ("data", "views"), devices=["cpu"] * 8)
    assert dict(dm.shape) == {"data": 2, "views": 4} and dm.size == 8
    blocks = view_sharding(dm).blocks(12)
    assert [b[1] for b in blocks] == [slice(0, 3), slice(3, 6), slice(6, 9),
                                      slice(9, 12)]
    assert replicated_sharding(dm).blocks(5) == [(torch.device("cpu"), slice(0, 5))]
    with pytest.raises(ValueError, match="divide"):
        view_sharding(dm).blocks(10)
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_device_mesh((4, 4), ("a", "b"), devices=["cpu"] * 8)


def test_render_views_sharded_matches_jax_and_the_port(small_scene):
    """8 views over 8 CPU slots: bit for bit the port's own render, and
    against the JAX package's sharded render over its 8 virtual devices
    the mask equal and the attributes within 5e-4. 6 views raise."""
    s = small_scene
    ref = jsweep.render_views_sharded(s["jm"], s["jc"], RES, RES, j_make_mesh(),
                                      render_attr=True)
    dm = _cpu_mesh()
    out = sweep.render_views_sharded(s["pm"], s["pc"], RES, RES, dm,
                                     render_attr=True)
    own = pt.render(s["pm"], s["pc"], RES, RES, render_attr=True, device="cpu")
    for name in ("mask", "attr", "pos", "depth", "normal"):
        assert torch.equal(getattr(out, name), getattr(own, name)), name
    np.testing.assert_array_equal(_np(out.mask), np.asarray(ref.mask))
    np.testing.assert_allclose(_np(out.attr), np.asarray(ref.attr), atol=5e-4,
                               rtol=0)
    with pytest.raises(ValueError, match="divide"):
        sweep.render_views_sharded(s["pm"], s["pc"][:6], RES, RES, dm)


# ---- the texel-sharded bake ----------------------------------------------------


@pytest.fixture(scope="module")
def bake_scene():
    """tests/test_parallel.py:213-231: the 33 x 65 sphere with a 256²
    texture of 0.25, 4 views at 64² and seeded 255-quantized frames; the
    JAX package's sharded bake over its 8 devices, and its silhouettes."""
    rng = np.random.default_rng(7)
    verts, faces, uv = uv_sphere_mesh(33, 65)
    tex = np.full((256, 256, 3), 0.25, np.float32)
    jm = wr.TexturedMesh(v_pos=jnp.asarray(verts, jnp.float32),
                         t_pos_idx=jnp.asarray(faces, jnp.int32),
                         v_tex=jnp.asarray(uv, jnp.float32),
                         t_tex_idx=jnp.asarray(faces, jnp.int32),
                         texture=jnp.asarray(tex))
    jc = wr.get_camera(elevation_deg=[15.0] * 4, distance=[2.6] * 4,
                       fovy_deg=[45.0] * 4, azimuth_deg=[0.0, 90.0, 180.0, 270.0])
    frames = rng.integers(0, 256, size=(4, 64, 64, 3)).astype(np.float32) / 255.0
    kw = dict(uv_size=256, poisson_blending=False, iou_rejection_threshold=None)
    ref = j_projection(frames, jm, jc, device_mesh=j_make_mesh(axis_names=("uv",)),
                       **kw)
    sil = np.asarray(wr.render(jm, jc, 64, 64, render_attr=False,
                               render_depth=False, render_normal=False).mask)
    return dict(pm=_port_mesh(jm), pc=_port_cam(jc), frames=frames, kw=kw,
                ref={f: np.asarray(getattr(ref, f)) for f in ref._fields},
                sil=sil.astype(np.float32))


def test_sharded_bake_matches_jax(bake_scene):
    """camera_projection(device_mesh=...) over 8 CPU slots at uv 256 against
    the JAX package's over 8 devices: mask flips within 1e-3 of the chart's
    texels, the texture and the aoi cosines within 5e-4 where both are
    valid."""
    s = bake_scene
    out = camera_projection(s["frames"], s["pm"], s["pc"],
                            device_mesh=_cpu_mesh(axis="uv"), **s["kw"])
    ref = s["ref"]
    m, rm = _np(out.uv_proj_mask), ref["uv_proj_mask"]
    assert rm.mean() > 0.1 and (m != rm).sum() <= 1e-3 * m.size
    both = m & rm
    np.testing.assert_allclose(_np(out.uv_proj)[both], ref["uv_proj"][both],
                               atol=5e-4, rtol=0)
    np.testing.assert_allclose(_np(out.uv_aoi_cos), ref["uv_aoi_cos"], atol=5e-4,
                               rtol=0)


def _full_kw(s):
    return dict(s["kw"], poisson_blending=True, pb_num_iters=40,
                iou_rejection_threshold=0.8, masks=s["sil"], device="cpu")


@pytest.fixture(scope="module")
def unsharded_bake(bake_scene):
    s = bake_scene
    return camera_projection(s["frames"], s["pm"], s["pc"], **_full_kw(s))


@pytest.mark.parametrize("texel_chunks", [1, 2, 4])
def test_sharded_bake_equals_the_unsharded_bake(bake_scene, unsharded_bake,
                                                texel_chunks):
    """8 bands x texel_chunks chunks, with masks and Poisson at 40 sweeps:
    every output bit for bit the port's unsharded camera_projection (the
    band ops are the unsharded ops on fewer rows)."""
    s, ref = bake_scene, unsharded_bake
    kw = _full_kw(s)
    out = camera_projection(s["frames"], s["pm"], s["pc"],
                            device_mesh=_cpu_mesh(axis="uv"),
                            texel_chunks=texel_chunks, **kw)
    for f in ref._fields:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


def test_sharded_bake_refusals(bake_scene):
    """Garbage masks reject (None) before the bake; a uv_size the bands
    and chunks do not divide, per-view bounds and warp_images raise."""
    s = bake_scene
    dm = _cpu_mesh(axis="uv")
    bad = np.zeros_like(s["sil"])
    kw = dict(s["kw"], iou_rejection_threshold=0.8)
    assert camera_projection(s["frames"], s["pm"], s["pc"], masks=bad,
                             device_mesh=dm, **kw) is None
    with pytest.raises(ValueError, match="divide"):
        camera_projection(s["frames"], s["pm"], s["pc"], device_mesh=dm,
                          texel_chunks=3, **s["kw"])
    with pytest.raises(ValueError, match="pos_error_eps"):
        camera_projection(s["frames"], s["pm"], s["pc"], device_mesh=dm,
                          pos_error_eps=torch.ones(4), **s["kw"])
    with pytest.raises(ValueError, match="pre-warped"):
        camera_projection(s["frames"], s["pm"], s["pc"], device_mesh=dm,
                          warp_images=True, images_background=0.5, **s["kw"])


# ---- bucketing and the sweep runner ----------------------------------------------


def test_pad_mesh_to_bucket_matches_jax(small_scene):
    """Padded buffers array-equal to the JAX package's; on the flat path
    (a 4,608-triangle grid padded to 16,384 faces) the padded render is bit
    for bit the unpadded one, the degenerate faces culled."""
    s = small_scene
    ref = jrunner.pad_mesh_to_bucket(s["jm"], vertex_buckets=(4096,),
                                     face_buckets=(4096,))
    out = runner.pad_mesh_to_bucket(s["pm"], vertex_buckets=(4096,),
                                    face_buckets=(4096,))
    assert out.num_vertices == out.num_faces == 4096
    for f in ("v_pos", "t_pos_idx", "v_tex", "t_tex_idx"):
        np.testing.assert_array_equal(_np(getattr(out, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    verts, faces = pt.make_grid_mesh(48, extent=1.0, height_fn=lambda x, y:
                                     0.3 * np.sin(3 * x) * np.cos(3 * y))
    grid = pt.mesh_from_arrays(verts, faces, device="cpu")
    padded = runner.pad_mesh_to_bucket(grid)
    assert padded.num_faces == 16384
    cam = s["pc"][:2]
    a = pt.render(grid, cam, RES, RES, render_attr=False, device="cpu")
    b = pt.render(padded, cam, RES, RES, render_attr=False, device="cpu")
    for name in ("mask", "pos", "depth", "normal"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _read_dir(root):
    return {p.relative_to(root).as_posix(): np.asarray(Image.open(p)).astype(np.int64)
            for p in sorted(Path(root).rglob("*.png"))}


def test_sweep_runner_resume_matches_jax(small_scene, tmp_path):
    """tests/test_parallel.py:96's sweep: two jobs (4 and 6 views, padded
    to 8 by repeating view 0), the padding trimmed, the PNGs written and
    within 1 LSB of the JAX runner's (16-bit depth within 5e-4 of its
    range), the progress file; a second runner
    skips both jobs. A corrupt progress file starts afresh."""
    s = small_scene

    def jobs(mod, mesh, cam):
        return [mod.RenderJob(name="job_a", mesh=mesh, cam=cam[0:4], height=RES,
                              width=RES),
                mod.RenderJob(name="job_b", mesh=mesh, cam=cam[0:6], height=RES,
                              width=RES)]

    ours_dir, ref_dir = tmp_path / "port", tmp_path / "jax"
    run = runner.SweepRunner(str(ours_dir), device_mesh=_cpu_mesh(),
                             bucket_meshes=False)
    results = run.run(jobs(runner, s["pm"], s["pc"]))
    assert results[0] is not None and results[1]["attr"].shape[0] == 6
    assert (ours_dir / "sweep_progress.json").exists()
    jrunner.SweepRunner(str(ref_dir), bucket_meshes=False).run(
        jobs(jrunner, s["jm"], s["jc"]))
    got, want = _read_dir(ours_dir), _read_dir(ref_dir)
    assert sorted(got) == sorted(want) and "job_a/rgb/rgb_00000.png" in got
    assert len(got) == 4 * (4 + 6)
    for k in want:
        # 8-bit frames within 1 LSB; 16-bit depth within the 5e-4 attribute
        # tolerance (33 LSB; 12 read: the clip transform at 153 vertices,
        # where XLA's CPU GEMM takes another order than the port's, moves
        # the positions, and so the normalized depth, 2.7e-4 from the
        # jitted reference's; given the same clip positions the per-tile
        # path is bit for bit, tests/test_torch_port_per_tile_trace.py)
        lsb = 33 if k.startswith(("job_a/depth", "job_b/depth")) else 1
        assert np.abs(got[k] - want[k]).max() <= lsb, k
    again = runner.SweepRunner(str(ours_dir), device_mesh=_cpu_mesh(),
                               bucket_meshes=False)
    assert again.run(jobs(runner, s["pm"], s["pc"])) == [None, None]
    (ours_dir / "sweep_progress.json").write_text("{not json")
    fresh = runner.SweepRunner(str(ours_dir), device_mesh=_cpu_mesh(),
                               bucket_meshes=False)
    assert fresh._done == set()


# ---- the texture-fit step --------------------------------------------------------


@pytest.fixture(scope="module")
def fit_scene(small_scene):
    """The true texture's views at FIT_RES² as targets, a constant start,
    and the JAX package's three optax Adam steps (lr 0.05) from a fresh
    state, with the state after each."""
    s = small_scene
    target = wr.render(s["jm"], s["jc"], FIT_RES, FIT_RES, render_attr=True).attr
    start = jnp.full_like(s["jm"].texture, 0.5)
    opt = optax.adam(0.05)
    step = jsweep.make_texture_fit_step(opt, FIT_RES, FIT_RES)
    tex, state = start, opt.init(start)
    trail = []
    for _ in range(3):
        tex, state, loss = step(tex, state, s["jm"], s["jc"], target)
        trail.append((np.asarray(tex), state, float(loss)))
    return dict(target=np.array(target), start=np.array(start), trail=trail)


def _port_fit(s, start, target, opt_state=None, n=3):
    tex = torch.tensor(start, requires_grad=True)
    opt = torch.optim.Adam([tex], lr=0.05)
    step = sweep.make_texture_fit_step(opt, FIT_RES, FIT_RES)
    out = []
    for i in range(n):
        tex, state, loss = step(tex, opt_state if i == 0 else None, s["pm"],
                                s["pc"], torch.from_numpy(target))
        out.append((tex.detach().clone(), state, float(loss)))
    return out


def test_texture_fit_step_matches_optax(small_scene, fit_scene):
    """Three torch Adam steps against optax.adam at lr 0.05: textures
    within 1e-5 (5.4e-6 read; Adam's update is lr times a ratio near +-1,
    rounded apart by the two optimizers), losses within 1e-4 relative
    (1.0e-5 read: the port's render lies a few ulp from the jitted
    reference's). From the JAX
    package's state after one step (adam_state_from_optax) one more step
    lands on its second step's texture."""
    f = fit_scene
    ours = _port_fit(small_scene, f["start"], f["target"])
    for (tex, _, loss), (want, _, want_loss) in zip(ours, f["trail"]):
        np.testing.assert_allclose(_np(tex), want, atol=1e-5, rtol=0)
        assert abs(loss - want_loss) <= 1e-4 * want_loss
    assert f["trail"][-1][2] < f["trail"][0][2]
    tex1, state1, _ = f["trail"][0]
    adam = state1[0]
    state = adam_state_from_optax(adam.count, adam.mu, adam.nu, device="cpu")
    resumed = _port_fit(small_scene, tex1, f["target"], opt_state=state, n=1)
    np.testing.assert_allclose(_np(resumed[-1][0]), f["trail"][1][0], atol=1e-5,
                               rtol=0)
    assert float(resumed[-1][1]["step"]) == 2.0


# ---- two gloo processes ------------------------------------------------------------

_WORKER = r"""
import sys
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np, torch
torch.set_num_threads(1)
import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch.mesh import uv_sphere_mesh
from worldrenderer_tpu_torch.parallel import dist, sweep
from worldrenderer_tpu_torch.utils import get_rank

dist.initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
assert dist.process_index() == rank and get_rank() == rank
assert dist.is_main_process() == (rank == 0) and dist.process_count() == 2
dist.barrier()
got = dist.broadcast_from_main(np.array([3.25 if rank == 0 else -1.0]))
assert got[0] == 3.25, got
verts, faces, uv = uv_sphere_mesh(9, 17)
tex = np.linspace(0, 1, 24 * 24 * 3, dtype=np.float32).reshape(24, 24, 3)
mesh = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                           texture=tex, device="cpu")
cam = pt.get_camera(elevation_deg=15.0, distance=3.0, fovy_deg=45.0,
                    num_views=3, near=0.1, far=10.0, device="cpu")
target = pt.render(mesh, cam, 64, 64, render_attr=True, device="cpu").attr
tex = torch.full_like(mesh.texture, 0.5).requires_grad_(True)
opt = torch.optim.Adam([tex], lr=0.05)
step = sweep.make_texture_fit_step(opt, 64, 64)
for _ in range(2):
    tex, state, loss = step(tex, None, mesh, cam, target)
dist.barrier()
if rank == 0:
    np.savez(out, tex=tex.detach().numpy(), loss=float(loss))
print(f"WORKER_{rank}_OK", flush=True)
"""


def test_two_process_gloo_fit_step(tmp_path):
    """Two processes join a gloo group on a free loopback port:
    process_index, is_main_process, barrier and broadcast_from_main; then
    two data-parallel fit steps over 3 views (blocks of 2 and 1, the
    gradient all-reduced by view count) equal the one-process steps on all
    3 views within 1e-6 (the texture) and 1e-6 relative (the loss). Each
    process has 60 s and is killed past it."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "rank0.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for key in ("RANK", "LOCAL_RANK", "SLURM_PROCID", "WORLD_SIZE"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(port),
                               str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, text=True)
             for r in range(2)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=60))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, results)):
        assert p.returncode == 0 and f"WORKER_{r}_OK" in so, (r, so, se[-3000:])

    verts, faces, uv = uv_sphere_mesh(9, 17)
    tex = np.linspace(0, 1, 24 * 24 * 3, dtype=np.float32).reshape(24, 24, 3)
    mesh = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                               texture=tex, device="cpu")
    cam = pt.get_camera(elevation_deg=15.0, distance=3.0, fovy_deg=45.0,
                        num_views=3, near=0.1, far=10.0, device="cpu")
    target = pt.render(mesh, cam, 64, 64, render_attr=True, device="cpu").attr
    one = torch.full_like(mesh.texture, 0.5).requires_grad_(True)
    opt = torch.optim.Adam([one], lr=0.05)
    for _ in range(2):
        one, _, loss = sweep.texture_fit_step(one, None, mesh, cam, target, opt,
                                              64, 64)
    got = np.load(out)
    np.testing.assert_allclose(got["tex"], _np(one), atol=1e-6, rtol=0)
    assert abs(float(got["loss"]) - float(loss)) <= 1e-6 * float(loss)


def test_single_process_coordination_is_a_no_op():
    """Without a group: rank 0, main process, a barrier that returns and a
    broadcast that hands the value back; one process never starts a
    group."""
    from worldrenderer_tpu_torch.parallel import dist

    dist.initialize_distributed("127.0.0.1:1", 1, 0, device="cpu")
    assert not torch.distributed.is_initialized()
    assert dist.process_index() == 0 and dist.is_main_process()
    dist.barrier()
    np.testing.assert_array_equal(dist.broadcast_from_main([1, 2]), [1, 2])
