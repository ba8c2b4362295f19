"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits nonzero before the last line:
  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build of every kernel from the package's csrc/, timed;
  3. every kernel against its plain PyTorch version on the card, bit for
     bit, at the shapes the main path gives it and on edge-case inputs;
  4. the main path — the headline G-buffer render of bench.py:434 (6 views
     at 512², positions + normals, a 10,082-triangle heightfield,
     auto_fast_config budgets) through ``render()`` — with every kernel's
     launch count read around it, its result held against the port's own
     CPU run, views/s and kernel times on the card, and the binning-budget
     guard (doubled budgets give the same mask, ids and z).
The second-to-last line is a JSON record of every kernel (launches, error
against the plain version, times, bound); the last line is the device
summary, printed only when every phase passed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): 67 TFLOP/s fp32 outside
# the tensor cores, counting each fused multiply-add as two operations, and
# HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# K1 is built with -fmad=false, so each multiply, add and compare is an
# fp32 instruction of its own, and the card issues at most one per lane per
# cycle: half the FMA-counted peak. Compares are counted at that rate too,
# which keeps the bound a least time.
PEAK_FP32_INSTR = PEAK_FP32_FLOPS / 2
# fp32 instructions per (entry, pixel) pair in K1's scan: four planes of
# (2 multiplies + 2 adds) and six compares (e0, e1, e2 >= 0, -1 <= z <= 1,
# z < zbest).
K1_OPS_PER_PAIR = 22


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_ms(fn, reps: int = 3):
    """One torch.profiler trace of ``reps`` calls: (wall ms per call,
    device-busy ms per call, CUDA kernels per call, top kernels as
    (name, ms per call, launches per call)). Kernel times are the trace's
    device self times; the wall time includes the tracer's own cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / reps
    launches = sum(e.count for e in rows) / reps
    top = [(e.key[:70], e.self_device_time_total / 1e3 / reps, e.count / reps)
           for e in rows[:6]]
    return wall, busy, launches, top


def headline_scene(pt, device, n=72, views=6):
    verts, faces = pt.make_grid_mesh(
        n, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y))
    mesh = pt.mesh_from_arrays(verts, faces, device=device)
    cam = pt.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                        num_views=views, near=0.1, far=10.0, device=device)
    return mesh, cam


def k1_inputs_for(pt, gb, mesh, cam, size):
    """The main path's K1 inputs for a scene: fast-config budgets from
    auto_fast_config, normals as the attribute channels."""
    mesh = pt.with_normals(mesh)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    cfg = pt.auto_fast_config(pos, mesh.t_pos_idx, (size, size))
    return gb._k1_inputs(pos, mesh.t_pos_idx, mesh.v_nrm, size, size, cfg,
                         pos_world=mesh.v_pos, mvp=cam.mvp_mtx), cfg


def synthetic_k1_inputs(device, c=128):
    """K1's edge cases, made from a seed: two views of 2x2 tiles of 16x128
    with a tile of 33 chunks, empty tiles, a dead tail, and a tile whose
    first and fourth chunks hold one full-tile plane 2c times over (exact
    z ties within and across chunks, increasing ids). Returns the inputs
    ``(recs, ids, start_chunks, n_chunks)`` on ``device`` and the static
    arguments ``(n_vals, tile_h, tile_w, n_ty, n_tx, c)``."""
    g = torch.Generator().manual_seed(3)
    n_vals, th, tw, n_ty, n_tx = 2, 16, 128, 2, 2
    nch = torch.tensor([[33, 0, 2, 1], [0, 5, 0, 1]], dtype=torch.int32)
    start = (torch.cumsum(nch, 1) - nch).to(torch.int32)
    l_cap = int(nch.sum(1).max()) * c
    recs = torch.zeros((2, 12 + 3 * n_vals, l_cap))
    recs[:, 2] = -3.0e38  # every lane dead unless written below
    ids = torch.full((2, l_cap), 10**6, dtype=torch.int32)
    for b in range(2):
        n_live = int(nch[b].sum()) * c - 37
        # edges: random lines through the tile; z planes with small slopes
        ang = torch.rand(3, n_live, generator=g) * 6.2832
        cx = torch.rand(3, n_live, generator=g) * tw
        cy = torch.rand(3, n_live, generator=g) * th
        for k in range(3):
            a, bb = torch.cos(ang[k]), torch.sin(ang[k])
            recs[b, 3 * k, :n_live] = a
            recs[b, 3 * k + 1, :n_live] = bb
            recs[b, 3 * k + 2, :n_live] = -(a * cx[k] + bb * cy[k])
        recs[b, 9, :n_live] = (torch.rand(n_live, generator=g) - 0.5) * 1e-3
        recs[b, 10, :n_live] = (torch.rand(n_live, generator=g) - 0.5) * 1e-2
        recs[b, 11, :n_live] = torch.rand(n_live, generator=g) * 1.6 - 0.8
        recs[b, 12:, :n_live] = torch.randn(3 * n_vals, n_live, generator=g)
        ids[b, :n_live] = torch.arange(n_live, dtype=torch.int32) + 70000
    tie = torch.zeros(12 + 3 * n_vals)
    tie[[2, 5, 8]] = 1.0  # covers the whole tile
    tie[11] = -0.9  # nearer than every random plane
    tie[12:] = torch.randn(3 * n_vals, generator=g)
    for chunk in (0, 3):  # view 1, tile 1 (chunks 0..4)
        recs[1, :, chunk * c:(chunk + 1) * c] = tie[:, None]
    inputs = tuple(t.to(device) for t in (recs, ids, start, nch))
    return inputs, (n_vals, th, tw, n_ty, n_tx, c)


def k1_against_plain(gc, inputs, dims) -> float:
    """Kernel and plain version on the same card inputs; raises unless z,
    id and vals are bitwise equal. Returns the max abs difference."""
    got = gc.gbuffer_tiles(*inputs, *dims)
    torch.cuda.synchronize()
    want = gc.gbuffer_tiles_plain(*inputs, *dims)
    err = 0.0
    for name, a, b in zip(("z", "id", "vals"), got, want):
        same = torch.equal(a, b)
        fin = torch.isfinite(a.float()) & torch.isfinite(b.float())
        d = (a.float() - b.float()).abs()[fin]
        err = max(err, float(d.max()) if d.numel() else 0.0)
        if not same:
            raise AssertionError(f"K1 {name} differs from the plain version "
                                 f"(max abs {err})")
    return err


def k1_bound_ms(inputs, dims) -> tuple:
    """Least time the card could take for K1's work on these inputs: the
    larger of the live (entry, pixel) pairs' unfused fp32 instructions over
    the card's fp32 instruction rate and the bytes it must move (each live
    record and id read once, each output written once) over the memory
    rate."""
    recs, ids, start, nch = inputs
    n_vals, th, tw, n_ty, n_tx, c = dims
    live_chunks = int(nch.sum())
    pairs = live_chunks * c * th * tw
    ops_ms = pairs * K1_OPS_PER_PAIR / PEAK_FP32_INSTR * 1e3
    n_out = recs.shape[0] * n_ty * th * n_tx * tw
    nbytes = (live_chunks * c * (recs.shape[1] + 1) * 4 + 2 * nch.numel() * 4
              + n_out * (2 + n_vals) * 4)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", live_chunks
    return bytes_ms, "bytes", live_chunks


def spread_report(pt, mesh, cam, dev, kw, out, ref) -> None:
    """Where the card's render parts from the CPU's. Normals: the vertex
    normals (``index_add_``, atomic adds on the card) against the CPU's and
    against a second card run, then the card's render given the CPU's
    vertex normals, and two card renders against each other. Positions:
    the batched inverse MVP of the two devices."""
    from worldrenderer_tpu_torch import mesh as pm

    def max_err(a, b, mask):
        return float((a.cpu() - b.cpu())[mask.cpu()].abs().max())

    def rows_differ(a, b):
        return int((a.cpu() != b.cpu()).any(-1).sum())

    v_c, t_c = mesh.v_pos.cpu(), mesh.t_pos_idx.cpu()
    vn_cpu = pt.compute_vertex_normals(v_c, t_c)
    vn_a = pt.compute_vertex_normals(mesh.v_pos, mesh.t_pos_idx)
    vn_b = pt.compute_vertex_normals(mesh.v_pos, mesh.t_pos_idx)
    log("spread", f"vertex normals, card vs CPU: {rows_differ(vn_a, vn_cpu)} "
        f"of {len(vn_cpu)} differ, max abs "
        f"{float((vn_a.cpu() - vn_cpu).abs().max())}; card run to run: "
        f"{rows_differ(vn_a, vn_b)} differ")
    # Each stage of the vertex normals on the card, given the CPU's input
    # to that stage.
    def cross(v, t):  # the face normals of compute_vertex_normals
        return torch.linalg.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])

    fn_c = cross(v_c, t_c)
    s_c = pm._sum_to_vertices(fn_c, t_c, len(v_c))
    s_g = s_c.to(dev)
    log("spread", "vertex normal stages, card vs CPU on the same input, rows "
        f"that differ: face normals "
        f"{rows_differ(cross(mesh.v_pos, mesh.t_pos_idx), fn_c)}, sums "
        f"{rows_differ(pm._sum_to_vertices(fn_c.to(dev), mesh.t_pos_idx, len(v_c)), s_c)}"
        f", _normalize_rows {rows_differ(pm._normalize_rows(s_g), pm._normalize_rows(s_c))}"
        f" (linalg.vector_norm {rows_differ(pt.normalize(s_g), pt.normalize(s_c))})")
    same_vn = pt.render(mesh._replace(v_nrm=vn_cpu.to(dev)), cam, 512, 512,
                        device=dev, **kw)
    again = pt.render(mesh, cam, 512, 512, device=dev, **kw)
    both = same_vn.mask.cpu() & ref.mask
    log("spread", f"render normals: card given the CPU's vertex normals vs "
        f"CPU max abs {max_err(same_vn.normal, ref.normal, both)}; card run "
        f"to run max abs {max_err(again.normal, out.normal, out.mask)}")
    inv_err = float((torch.linalg.inv(cam.mvp_mtx).cpu()
                     - torch.linalg.inv(cam.mvp_mtx.cpu())).abs().max())
    log("spread", f"inverse MVP, card vs CPU: max abs {inv_err}; card given "
        f"the CPU's vertex normals, pos vs CPU max abs "
        f"{max_err(same_vn.pos, ref.pos, both)}")


def main() -> int:
    # The port must come from the checkout this script sits in (first on
    # sys.path), never from an installed copy: alone in a directory, the
    # script fails.
    root = Path(__file__).resolve().parent
    if not (root / "worldrenderer_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no worldrenderer_tpu_torch package in {root}",
              file=sys.stderr)
        return 1
    import worldrenderer_tpu_torch as pt
    from worldrenderer_tpu_torch.ops import _build
    from worldrenderer_tpu_torch.ops import gbuffer as gb
    from worldrenderer_tpu_torch.ops import gbuffer_cuda as gc

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = smi()
    log("env", card)
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = _build.build(["gbuffer_tiles"])
    log("build", f"gbuffer_tiles built in {time.perf_counter() - t0:.2f} s")
    for line in logs["gbuffer_tiles"].splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

    # Phase 3: K1 against its plain version on the card.
    mesh, cam = headline_scene(pt, dev)
    head_inputs, head_cfg = k1_inputs_for(pt, gb, mesh, cam, 512)
    head_k1, head_dims = head_inputs
    big_mesh, big_cam = headline_scene(pt, dev, n=188)
    assert big_mesh.num_faces == 69_938
    big_k1, big_dims = k1_inputs_for(pt, gb, big_mesh, big_cam, 1024)[0]
    syn_k1, syn_dims = synthetic_k1_inputs(dev)
    max_err = 0.0
    for name, inputs, dims in (("headline", head_k1, head_dims),
                               ("grid188_1024", big_k1, big_dims),
                               ("synthetic", syn_k1, syn_dims)):
        err = k1_against_plain(gc, inputs, dims)
        max_err = max(max_err, err)
        log("k1", f"{name}: live chunks {int(inputs[3].sum())}, bitwise "
            f"equal to the plain version (max abs err {err})")

    # Phase 4: the main path through render(), launch counts around it.
    kw = dict(render_attr=False, render_depth=False, render_normal=True,
              raster_config=head_cfg)
    gc.launch_count = 0
    out = pt.render(mesh, cam, 512, 512, device=dev, **kw)
    torch.cuda.synchronize()
    launches = gc.launch_count
    if launches < 1:
        raise AssertionError("render() did not launch K1")
    log("main", f"render(): K1 launches {launches}")

    ref = pt.render(mesh.to("cpu"), cam.to("cpu"), 512, 512, device="cpu", **kw)
    fg = int(ref.mask.sum())
    mask_diff = int((out.mask.cpu() != ref.mask).sum())
    both = out.mask.cpu() & ref.mask
    pos_err = float((out.pos.cpu() - ref.pos)[both].abs().max())
    nrm_err = float((out.normal.cpu() - ref.normal)[both].abs().max())
    log("main", f"vs the port on the CPU: mask diff {mask_diff} of {fg} "
        f"foreground, pos max err {pos_err}, normal max err {nrm_err}")
    if not (mask_diff <= 1e-4 * fg and pos_err < 1e-4 and nrm_err < 5e-4
            and torch.isfinite(out.pos).all() and fg > 500_000):
        raise AssertionError("GPU render disagrees with the CPU render")
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    g_gpu = pt.rasterize_gbuffer(pos, mesh.t_pos_idx, None, (512, 512),
                                 head_cfg, device=dev)
    g_cpu = pt.rasterize_gbuffer(pos.cpu(), mesh.t_pos_idx.cpu(), None,
                                 (512, 512), head_cfg, device="cpu")
    id_diff = int((g_gpu.tri_id.cpu() != g_cpu.tri_id).sum())
    log("main", f"tri_id diff GPU vs CPU: {id_diff}")
    if id_diff > 1e-4 * fg:
        raise AssertionError("GPU triangle ids disagree with the CPU")
    spread_report(pt, mesh, cam, dev, kw, out, ref)

    n_reps = 20
    render_ms = cuda_ms(
        lambda: pt.render(mesh, cam, 512, 512, device=dev, **kw), n_reps)
    views_per_s = len(cam) / (render_ms / 1e3)
    nmesh = pt.with_normals(mesh)
    prep_ms = cuda_ms(lambda: gb._k1_inputs(
        pos, nmesh.t_pos_idx, nmesh.v_nrm, 512, 512, head_cfg,
        pos_world=nmesh.v_pos, mvp=cam.mvp_mtx), n_reps)
    k1_ms = cuda_ms(lambda: gc.gbuffer_tiles(*head_k1, *head_dims), 50)
    plain_ms = cuda_ms(lambda: gc.gbuffer_tiles_plain(*head_k1, *head_dims), 3)
    bound_ms, bound_by, live = k1_bound_ms(head_k1, head_dims)
    log("main", f"headline render {render_ms:.4f} ms = {views_per_s:.2f} "
        f"views/s ({card}); K1 {k1_ms:.4f} ms per render "
        f"({100 * k1_ms / render_ms:.1f}%), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms by {bound_by} ({live} live chunks)")
    log("main", f"stages: prep (setup, binning, chunks) {prep_ms:.4f} ms, "
        f"K1 {k1_ms:.4f} ms, the rest (clip transform, normals, "
        f"unprojection) {render_ms - prep_ms - k1_ms:.4f} ms")

    wall, busy, n_kernels, top = profile_ms(
        lambda: pt.render(mesh, cam, 512, 512, device=dev, **kw))
    if n_kernels:
        log("profile", f"traced render {wall:.3f} ms wall, device busy "
            f"{busy:.3f} ms ({100 * (1 - busy / wall):.1f}% idle), "
            f"{n_kernels:.0f} CUDA kernels per render")
        for name, ms, count in top:
            log("profile", f"{ms:8.4f} ms {count:5.0f}x {name}")
    else:
        log("profile", "device time not measured: the trace holds no CUDA "
            "kernels")

    # Binning-budget guard: doubled lossy budgets give the same G-buffer.
    cfg2 = head_cfg._replace(
        max_tris_per_tile=2 * head_cfg.max_tris_per_tile,
        bin_flat_cap_factor=2 * head_cfg.bin_flat_cap_factor,
        bin_huge=2 * head_cfg.bin_huge, bin_med=2 * head_cfg.bin_med,
    )
    g2 = pt.rasterize_gbuffer(pos, mesh.t_pos_idx, None, (512, 512), cfg2,
                              device=dev)
    guard = {
        "mask_diff": int((g_gpu.mask != g2.mask).sum()),
        "id_diff": int((g_gpu.tri_id != g2.tri_id).sum()),
        "z_diff": float((g_gpu.z - g2.z).abs().max()),
    }
    log("guard", f"doubled budgets: {guard}")
    if guard["mask_diff"] or guard["id_diff"] or guard["z_diff"] >= 1e-6:
        raise AssertionError(f"binning budgets truncate triangle lists: {guard}")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "gbuffer_tiles",
        "route": "cuda",
        "source": "worldrenderer_tpu_torch/csrc/gbuffer_tiles.cu",
        "replaces": "worldrenderer_tpu/ops/gbuffer_pallas.py:860",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
