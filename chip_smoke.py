"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits nonzero before the last line:
  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build of every kernel from the package's csrc/, timed; [camera]:
     ``get_camera`` on the card against ``get_camera`` on the CPU, bit for
     bit (the headline's 6 views, config4's 4), beside the count of
     elements the same matrices differ by when built on the card;
  3. every kernel against its plain PyTorch version on the card, bit for
     bit, at the shapes the main path gives it and on edge-case inputs (the
     probes P1-P3 at their own shapes, P1 also on the headline's chunk
     runs, with every count 0, on runs longer than its register group and
     at c = 256 and 32, P3 also where its indices wrap, at R 300, 37 and
     5; K1 on exact +0 / -0 ties across a 10-chunk tile; K2, K3 and
     K4 on exact ties within one lane slot across chunks, K2 and K3 at
     c = 128 and 256; K3 on -0 / +0 ties across lane slots, its z's sign
     held to the TPU kernel's rule; K2 and K4 on the same planes, every
     covered z +0; K1, K2 and K3 at a tile width of 96, no power of two;
     K2, K3 and K4 on 64x128 tiles),
     with times, bounds and library calls; for K1 and K3, the readings
     that test what bounds them ([k1] balance: the inputs as laid against
     the same chunks re-laid evenly over the tiles; [k3] reduction: the
     counts as given against all 0); K2 and K4 with every count 0 (what
     the grid's blocks that exit at once cost); a run of each tile
     kernel's wrapper with every device-to-host sync an error ([sync]),
     and each tile kernel's registers, shared memory and resident blocks
     per SM; P1's and P3's kernels timed alone from a torch.profiler trace
     beside their wrappers, an empty launch, P3's registers and blocks per
     SM;
  4. the main path — the headline G-buffer render of bench.py:434 (6 views
     at 512², positions + normals, a 10,082-triangle heightfield,
     auto_fast_config budgets) through ``render()`` — with every kernel's
     launch count read around it, its result held against the port's own
     CPU run, views/s and kernel times on the card, and the binning-budget
     guard (doubled budgets give the same mask, ids and z); [normals]: the
     face normals' cross product, ``compute_vertex_normals`` and
     ``normalize`` on the card bit for bit against the CPU on the headline
     mesh and the bake sphere, beside the rendered normals' difference;
  5. slice 2's paths, each with its launch counts read around it and its
     result held against the port's CPU run: [tiles] workload 1 (the
     3,968-triangle UV sphere, 6 views at 512²) with the fused_pallas
     (K2), vpu_pallas (K3) and pallas (K4) backends; [atlas] workload 2,
     the bake's 2048² UV-atlas pass (K4); [classic] workload 3,
     ``rasterize`` and ``rasterize_db`` on the flat path (K1 in uv mode);
     [flat] the headline through ``rasterize_gbuffer`` with ``vpu_pallas``
     (K3) and ``fused_xla`` (K2) on flat-binned tile rows, as the JAX
     package routes them at scale: each kernel bitwise against its plain
     version on those rows, view 0 against the port's CPU run;
  6. slice 3's paths, each with its launch counts read around it:
     [texture] bench.py:731's config4 (4 views at 1024², textured colour,
     depth and normals) with texture_pack_mode none (against the port's
     CPU run), u8 (equal to none) and the split-UV mesh through render's
     own seam cut (equal to the explicitly unified mesh), each with the
     texture call timed alone; [attr] workload 1 with a 512² checker:
     fused with tangents (K2), classic with antialias_attr (K4), auto_mip;
     [chunk] bench.py:614's config2 with view_chunk=8 against unchunked;
     [ssaa] the headline at ssaa=2; [probes] the entry points of P1-P3;
     [sample] S1, the bake's bilinear sampler, bit for bit against
     ``grid_sample_parts``'s plain version on edge-case inputs and on the
     two calls of a tex4k-shaped bake, its time beside its byte bound, the
     plain version's and ``F.grid_sample``'s, and its launches per bake
     (2) and per textured render (0);
  7. slice 7's paths, each with its launch counts read around it and its
     wall seconds: [town] bench.py:395's town (tests/data/town.glb and its
     camera path loaded onto the card, 8 frames at 384x576, the strip
     atlas, backface_cull -1; K1) against the port's CPU render, and the
     cull property of tests/test_town_fixture.py; [tiny] both raw
     1M-triangle scenes of bench.py:298-367 through the sub-pixel sort path
     (K1 beside it), their budgets and candidate caps, view 0 against the
     CPU, the cap on against off and the path on against off bit for bit,
     and vpu_pallas (K3) and fused_xla (K2) with the path on; [lod]
     bench.py:867's LOD chain over the 1M heightfield (the host's meshproc,
     built with g++ beside the kernels) and its selected level's render;
  8. slice 8's paths, the same way: [subtile] K1's row bands
     (bin_subtile 2 and 4) on the headline and on a 152-row scene, K1
     bitwise against its plain version on the banded inputs and the
     G-buffer bitwise against bin_subtile 1, K1's time at each; [bake]
     bench.py:898's UV bake at full width (uv 2048², 6 views at 512²,
     16,384 triangles): seconds per bake, its stage split, kernels and idle
     share from a trace, K1 at the 2048² atlas, and camera_projection
     against the port's CPU run; [bake_full] bench.py:963's bake with
     1,000 Poisson sweeps and gutter padding, the loop's ms and kernels
     per sweep, and the post-blend on the card against the CPU;
  9. slice 10's paths, the same way: [diff] rasterize_diff on workload 1
     (K4) and on the headline (K1 in uv mode), the primal bitwise equal to
     rasterize and view 0's clip-position gradient against the CPU's, and
     a texture-fit step on config4 (K1) with view 0's texture gradient
     against the CPU's, forward and backward ms and kernels per step;
     [warp] compute_warp_field on the bake's scene and
     camera_projection(warp_images=True) end to end against the CPU;
     [paint] SmartPainter at the application's settings (score 108 x 256²,
     inpaint 1024², 4-8 rounds), seconds per round, a round's stage split
     and idle share, and one round against the CPU at score 128² and
     inpaint 512²;
 10. slice 11's application, the same way: [app] ``project_and_render`` as
     the CLI runs it on the committed town (24 frames of its path at
     384x576, uv 2048, the host atlas, raster exact, pos_error_eps auto;
     the footage rendered on the card and handed in for the one name
     ``load_frames``, as the card's machine has no OpenCV), its seconds
     traced and warm and its parts', K1's launches, kernels and idle share,
     K1 bitwise against its plain version on every input shape the call
     gave it, the re-render against the footage, and 4 frames at 192x288,
     uv 512, against the CPU (the written files decoded by the port's
     codec); [texpipe] ``TexturePipeline`` on the six-view ORTHO rig at
     768², uv 4096 (rgb upscaled x2 and inpainted by the painter, base
     colour, the normal map rebaked), seconds per call and per modality,
     painter rounds, kernels and idle share from the one traced call, K1
     the same way, and the call at 128², uv 256, uv inpainting, against
     the CPU;
 11. slice 12's multi-device paths on a mesh of the one card, the same
     way: [shard] bench.py:1013's bake (uv 4096, 6 views at 768²) through
     ``camera_projection(device_mesh=..., texel_chunks=8)``, its seconds,
     peak memory at 8 chunks against 1, kernels and idle share, K1 on its
     inputs and the result bit for bit the unsharded bake;
     ``render_views_sharded`` and ``SweepRunner`` (two bucket-padded
     jobs, resumed) bitwise against ``render()``; ``texture_fit_step``
     against the plain Adam loop; the validate gates (K1 against K3, the
     degenerate probes) with their verdicts; ``measure_kernel_mfu``. No
     process group is started.
To stay within 300 s, the CPU comparisons of earlier phases were cut:
[tiles] none (its paths are held by [attr], [flat], [classic] and
[diff]), [classic], [texture] and [lod] view 0, [town] frames 0 and 4,
[bake] none ([warp] holds the same bake against the CPU with its limits),
[bake_full] 40 sweeps on the CPU. [app]'s and [texpipe]'s CPU runs go in
a process of their own, started with their inputs before [town]. The
CPU runs that [main],
[flat], [attr] and [diff] hold the card against go in a process of their
own at the lowest priority (CpuReferences), started first and running
beside every phase; [warp]'s and [paint]'s in another, started with their
inputs before [bake] (Slice10). The phases' host-bound times are taken
beside them.
The second-to-last line is a JSON record of every kernel (launches on the
main paths, error against the plain version, times, bound); the last line
is the device summary, printed only when every phase passed.

    python3 chip_smoke.py --k1-k4 ROOT
    python3 chip_smoke.py --probes ROOT
    python3 chip_smoke.py --sample

time only the tile kernels K1-K4 (``[k1] balance``, ``[k3] reduction``,
K2 and K4 as given and with every count 0), or only P1's and P3's wrappers
and kernels, with the port imported from ROOT, to compare two versions on
one card (k1_k4_readings, probe_readings); or only the [sample] phase
(sample_readings).

    python3 chip_smoke.py --multi-card

runs the multi-device paths across every card of the machine (a machine
of four H100s): the sharded bake over all cards against card
0's, the view split against ``render()``, and the data-parallel fit in
one nccl process per card (``--fit-rank``) against one process
(multi_card_readings).

"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import hashlib
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# The H100's peaks and the kernels' instruction counts (PEAK_FP32_FLOPS,
# PEAK_FP32_INSTR, PEAK_BYTES, K1_OPS_PER_PAIR, OPS_PER_ENTRY_ROW,
# OPS_PER_ENTRY_COL, TILE_OPS_PER_PAIR) and K1's bound (k1_bound_ms) are the
# port's worldrenderer_tpu_torch/utils/roofline.py's, bound to these names by
# main() once it has found the port beside this script.

# Shared memory serves 32 banks of 4 bytes per clock on each of the 132
# SMs; the clock is the card's maximum SM clock (nvidia-smi clocks.max.sm).
SMEM_BYTES_PER_CLOCK_SM = 128
N_SMS = 132


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def profile_ms(fn, reps: int = 3, warm: bool = True, host_ops: bool = True):
    """One torch.profiler trace of ``reps`` calls, after a warm-up call
    unless ``warm`` is False (``fn`` ran warm already): (wall ms per call,
    device-busy ms per call, CUDA kernels per call, top kernels as
    (name, ms per call, launches per call)). Kernel times are the device
    spans of the trace's kernels and copies, summed by name from the raw
    trace (key_averages builds an event tree first: 30 s for a call of
    150,000 kernels); the wall time includes the tracer's own cost.
    ``host_ops`` False traces the device alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    # Device events of the trace, less the device spans of profiler ranges.
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    busy = sum(ms for _, (ms, _) in rows) / reps
    launches = sum(n for _, (_, n) in rows) / reps
    top = [(name[:70], ms / reps, n / reps) for name, (ms, n) in rows[:6]]
    return wall, busy, launches, top


def kernel_device_ms(fn, name: str, reps: int = 50):
    """Mean device milliseconds per launch of the CUDA kernels whose name
    holds ``name``, from one torch.profiler trace of ``reps`` calls of
    ``fn`` after one warm-up call; None when the trace holds no such
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in rows)
    if not count:
        return None
    return sum(e.self_device_time_total for e in rows) / 1e3 / count


def bits_differ(a, b) -> int:
    """Elements of two float32 tensors whose bits differ (compared on the
    first one's device)."""
    return int((a.contiguous().view(torch.int32)
                != b.to(a.device).contiguous().view(torch.int32)).sum())


CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")


def camera_phase(pt, dev) -> None:
    """``get_camera(device="cuda")`` against ``get_camera(device="cpu")``,
    every field bit for bit, for the headline's 6 views and config4's 4
    views. Beside it, the elements in which the same matrices differ when
    the camera helpers build them on the card (``get_c2w``,
    ``get_projection_matrix``, ``affine_inverse`` and the product there):
    how ``get_camera`` built them before it built them on the host."""
    for name, views in (("headline", 6), ("config4", 4)):
        kw = dict(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                  num_views=views, near=0.1, far=10.0)
        card = pt.get_camera(device=dev, **kw)
        host = pt.get_camera(device="cpu", **kw)
        c2w = pt.get_c2w(35.0, 3.0, None, views, dev)
        w2c = pt.affine_inverse(c2w)
        proj = pt.get_projection_matrix(50.0, near=0.1, far=10.0,
                                        device=dev).expand(views, 4, 4)
        on_card = dict(c2w=c2w, w2c=w2c, proj_mtx=proj,
                       mvp_mtx=torch.matmul(proj, w2c), cam_pos=c2w[:, :3, 3])
        after = {f: bits_differ(getattr(card, f), getattr(host, f))
                 for f in CAM_FIELDS}
        before = {f: bits_differ(on_card[f], getattr(host, f))
                  for f in CAM_FIELDS}
        log("camera", f"{name} ({views} views): get_camera on the card vs on "
            f"the CPU, differing elements {after}; built on the card by the "
            f"helpers {before}")
        if any(after.values()) or card.mvp_mtx.device.type != "cuda":
            raise AssertionError(f"{name}: the card's camera differs from the "
                                 "CPU's")


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
                         pos_world=mesh.v_pos, mvp=cam.mvp_mtx)[:2], cfg


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


def synthetic_sample_inputs(device):
    """S1's edge cases, made from a seed: a list of (name, parts, grid),
    parts as ``grid_sample_parts`` takes them, on ``device``. At N = 6 and
    N = 1, its first view (9x13 maps, a 7x37 grid: a warp row and a ragged
    one): a 5-channel fp32 part with NaN and +-inf taps in every view (in
    the image and on its first row, last column and a corner), a 3-channel
    'u8' part (k/255 values, some beyond [0, 1]) and a 1-channel fp32 part;
    NDC at exactly -1 and 1, at x0 = -1 and x0 = W-1 (and y0 likewise), far
    out of range (+-1e10, +-3e9, +-inf, NaN) and at random in [-1.3, 1.3].
    Then nine 1-channel parts of alternating modes (two launches) and one
    27-channel part (outputs written unstaged), at N = 2."""
    g = torch.Generator().manual_seed(18)
    h, w, hg, wg = 9, 13, 7, 37
    nan, inf = float("nan"), float("inf")

    def grid_for(n):
        grid = (torch.rand((n, hg, wg, 2), generator=g) * 2.6 - 1.3)
        # x0 = -1 and x0 = W-1 (x = -0.75, W-0.75); likewise y0.
        lo_x, hi_x = -1.0 - 0.5 / w, (w - 0.25) * 2.0 / w - 1.0
        lo_y, hi_y = -1.0 - 0.5 / h, (h - 0.25) * 2.0 / h - 1.0
        special = torch.tensor(
            [[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [1.0, -1.0],
             [lo_x, 0.0], [hi_x, 0.0], [0.0, lo_y], [0.0, hi_y],
             [lo_x, lo_y], [hi_x, hi_y], [1e10, 0.0], [-1e10, 0.0],
             [0.0, 1e10], [0.0, -1e10], [3e9, -3e9], [-3e9, 3e9],
             [inf, 0.0], [-inf, 0.0], [0.0, inf], [0.0, -inf],
             [nan, 0.0], [0.0, nan], [nan, nan], [-1e10, -1e10]])
        for v in range(n):
            row = v % hg
            grid[v, row, :len(special)] = special
        return grid

    def maps(n):
        geo = torch.randn((n, h, w, 5), generator=g)
        geo[:, 3, 4, 0] = nan
        geo[:, 3, 5, 1] = inf
        geo[:, 5, 6, 2] = -inf
        geo[:, 0, :, 3] = nan  # the first row
        geo[:, :, w - 1, 4] = inf  # the last column
        geo[:, h - 1, 0] = -inf  # a corner, every channel
        rgb = torch.randint(0, 256, (n, h, w, 3), generator=g).float() / 255.0
        rgb[0, 1, 1] = torch.tensor([-0.2, 1.3, 0.5])
        mask = (torch.rand((n, h, w, 1), generator=g) > 0.4).float()
        return geo, rgb, mask

    geo, rgb, mask = maps(6)
    parts = [(geo, "none"), (rgb, "u8"), (mask, "none")]
    grid = grid_for(6)
    cases = [("edges_n6", parts, grid),
             ("edges_n1", [(t[:1].contiguous(), pm) for t, pm in parts],
              grid[:1].contiguous())]
    geo, rgb, mask = maps(2)
    singles = [geo[..., i:i + 1] for i in range(5)] + [
        rgb[..., i:i + 1] for i in range(3)] + [mask]
    cases.append(("nine_parts", [(t.contiguous(), "u8" if i % 2 else "none")
                                 for i, t in enumerate(singles)], grid_for(2)))
    wide = torch.cat([geo, rgb, mask] * 3, dim=-1)
    cases.append(("wide_c27", [(wide, "none")], grid_for(2)))
    return [(name, [(t.to(device), pm) for t, pm in parts], grid.to(device))
            for name, parts, grid in cases]


def synthetic_k1_tie_inputs(device, c=128):
    """K1's exact z ties across the chunks of a heavy tile, made from a
    seed: one view of 2x2 tiles of 16x128; tile 0 holds 10 chunks of random
    planes behind z = 0.1 and constant planes at z = +0 and -0 (a = b = g =
    z, so a -0 plane evaluates to -0): on its left half +0 (chunk 1), then
    -0 (chunk 4), then +0 (chunk 8); on its right half -0 (chunk 2), then
    +0 (chunk 6), then -0 (chunk 9); on its lower rows three planes at
    z = -0.5 (chunk 3 lanes 100 and 5, chunk 7 lane 0). The first in list order must win each tie
    (-0 == +0): chunk 1 lane 7, chunk 2 lane 3 and chunk 3 lane 5. Tile 1
    is empty, tile 2 holds 9 chunks of random planes, tile 3 one. Returns
    the inputs ``(recs, ids, start_chunks, n_chunks)`` on ``device``, the
    static arguments ``(n_vals, tile_h, tile_w, n_ty, n_tx, c)`` and the
    winning entries ``{name: entry}``."""
    g = torch.Generator().manual_seed(9)
    n_vals, th, tw, n_ty, n_tx = 2, 16, 128, 2, 2
    nch = torch.tensor([[10, 0, 9, 1]], dtype=torch.int32)
    start = (torch.cumsum(nch, 1) - nch).to(torch.int32)
    l_cap = (int(nch.sum()) + 2) * c  # two dead chunks past the runs
    n_rows = 12 + 3 * n_vals
    recs = torch.zeros((1, n_rows, l_cap))
    recs[:, 2] = -3.0e38
    n_live = int(nch.sum()) * c
    ang = torch.rand(3, n_live, generator=g) * 6.2832
    cx = torch.rand(3, n_live, generator=g) * tw
    cy = torch.rand(3, n_live, generator=g) * th
    for k in range(3):
        a, bb = torch.cos(ang[k]), torch.sin(ang[k])
        recs[0, 3 * k, :n_live] = a
        recs[0, 3 * k + 1, :n_live] = bb
        recs[0, 3 * k + 2, :n_live] = -(a * cx[k] + bb * cy[k])
    recs[0, 9, :n_live] = (torch.rand(n_live, generator=g) - 0.5) * 1e-3
    recs[0, 10, :n_live] = (torch.rand(n_live, generator=g) - 0.5) * 1e-2
    recs[0, 11, :n_live] = torch.rand(n_live, generator=g) * 0.7 + 0.15
    recs[0, 12:, :n_live] = torch.randn(3 * n_vals, n_live, generator=g)
    ids = torch.full((1, l_cap), 10**6, dtype=torch.int32)
    ids[0, :n_live] = torch.arange(n_live, dtype=torch.int32) * 3 + 500

    def plane(e, z, edge):
        recs[0, :12, e] = 0.0
        recs[0, [2, 5, 8], e] = 1.0  # edges 1 and 2 cover the whole tile
        recs[0, 0:3, e] = torch.tensor(edge)  # edge 0 picks the region
        recs[0, 11, e] = z
        if z == 0.0:  # a = b = g = z: a -0 plane evaluates to -0
            recs[0, 9:11, e] = z
        recs[0, 12:, e] = torch.randn(3 * n_vals, generator=g)

    left, right, low = (-1.0, 0.0, 64.0), (1.0, 0.0, -64.0), (0.0, 1.0, -8.0)
    for chunk, lane, z, edge in ((1, 7, 0.0, left), (4, 11, -0.0, left),
                                 (8, 2, 0.0, left), (2, 3, -0.0, right),
                                 (6, 9, 0.0, right), (9, 0, -0.0, right),
                                 (3, 100, -0.5, low), (3, 5, -0.5, low),
                                 (7, 0, -0.5, low)):
        plane(chunk * c + lane, z, edge)
    winners = {"+0 first": 1 * c + 7, "-0 first": 2 * c + 3,
               "-0.5 first": 3 * c + 5}
    inputs = tuple(t.to(device) for t in (recs, ids, start, nch))
    return inputs, (n_vals, th, tw, n_ty, n_tx, c), winners


def tie_tile_blocks(seed, c, n_vals, z_lo, z_span, ties, counts):
    """Per-tile blocks of 4 tiles of 16x128, K = 3c + 44 entries, made from
    ``seed``: random planes at z in [z_lo, z_lo + z_span) with ids 3e +
    10000, and for each tile t the full-tile constant planes ``ties[t]``,
    (chunk, slot, z, id) at entry e = chunk * c + slot. A zero z is the
    plane a = b = g = z, so a -0 plane evaluates to -0. ``counts`` are the
    tiles' live entries. Returns ``(coeffs (4, 3, (5 + n_vals) * K), counts
    (4,) i32)`` on the CPU."""
    g = torch.Generator().manual_seed(seed)
    n_tiles, k, th, tw = 4, 3 * c + 44, 16, 128
    r = 5 + n_vals
    co = torch.zeros((n_tiles, 3, r, k))
    ang = torch.rand(n_tiles, 3, k, generator=g) * 6.2832
    cx = torch.rand(n_tiles, 3, k, generator=g) * tw
    cy = torch.rand(n_tiles, 3, k, generator=g) * th
    for e in range(3):
        a, b = torch.cos(ang[:, e]), torch.sin(ang[:, e])
        co[:, 0, e], co[:, 1, e] = a, b
        co[:, 2, e] = -(a * cx[:, e] + b * cy[:, e])
    co[:, 0, 3] = (torch.rand(n_tiles, k, generator=g) - 0.5) * 1e-3
    co[:, 1, 3] = (torch.rand(n_tiles, k, generator=g) - 0.5) * 1e-2
    co[:, 2, 3] = torch.rand(n_tiles, k, generator=g) * z_span + z_lo
    co[:, 2, 4] = (torch.arange(k, dtype=torch.float32) * 3 + 10000)[None]
    co[:, :, 5:] = torch.randn(n_tiles, 3, n_vals, k, generator=g)
    for t, planes in ties.items():
        for chunk, slot, z, tid in planes:
            e = chunk * c + slot
            co[t, :, :4, e] = 0.0
            co[t, 2, :3, e] = 1.0  # covers the whole tile
            co[t, 2, 3, e] = z
            if z == 0.0:
                co[t, :, 3, e] = z
            co[t, 2, 4, e] = float(tid)
    return (co.reshape(n_tiles, 3, r * k).contiguous(),
            torch.tensor(counts, dtype=torch.int32))


def slot_tie_tile_inputs(device, c=128, n_vals=2):
    """K2's and K3's exact z ties within one lane slot across chunks
    (``tie_tile_blocks``, seed 13, random planes at z in [-0.7, 0.8)), with
    ids that do not follow list order (e = chunk * c + slot):
      tile 0: z -0.99 at (0, 10) id 600, (1, 10) id 500, (1, 20) id 550;
        K3 keeps (0, 10) in slot 10, so (1, 20) wins; K2 takes (0, 10);
      tile 1: z -0.9 at (0, 3) id 100, z -0.99 at (1, 7) id 900 and
        (2, 3) id 50; slot 3 reaches -0.99 only in chunk 2, so K3 takes
        (2, 3); K2 (1, 7);
      tile 2: z -0.99 at (0, 5) id 700, (1, 9) id 800, (2, 5) id 10; slot 5
        keeps (0, 5), which wins for both;
      tile 3: count 2c + 1, z -0.99 at (0, 40) id 300 and (1, 40) id 200;
        K3 keeps (0, 40); K2 too.
    K4 (on the geometry blocks, ``zid_tile_inputs``) takes the first entry
    in list order at the least z: K2's entries here.
    Returns ``(coeffs, counts)`` on ``device`` and the winning entries
    ``{kernel: [entry per tile]}``."""
    ties = {0: [(0, 10, -0.99, 600), (1, 10, -0.99, 500), (1, 20, -0.99, 550)],
            1: [(0, 3, -0.9, 100), (1, 7, -0.99, 900), (2, 3, -0.99, 50)],
            2: [(0, 5, -0.99, 700), (1, 9, -0.99, 800), (2, 5, -0.99, 10)],
            3: [(0, 40, -0.99, 300), (1, 40, -0.99, 200)]}
    k = 3 * c + 44
    out = tie_tile_blocks(13, c, n_vals, -0.7, 1.5, ties, [k, k, k, 2 * c + 1])
    winners = {"zattr_tiles_vpu": [c + 20, 2 * c + 3, 5, 40],
               "zattr_tiles": [10, c + 7, 5, 40],
               "raster_zid_tiles": [10, c + 7, 5, 40]}
    return tuple(t.to(device) for t in out), winners


def zero_sign_tile_inputs(device, c=128, n_vals=2):
    """K3's exact ties at z = -0 and +0 across lane slots
    (``tie_tile_blocks``, seed 17, random planes at z in [0.1, 0.9)):
      tile 0: +0 at (0, 10) id 600, -0 at (0, 20) id 700;
      tile 1: -0 at (0, 10) id 600, +0 at (1, 20) id 500;
      tile 2: +0 at (0, 10) id 600, -0 at (1, 10) id 500 (slot 10 keeps
        its +0);
      tile 3: tile 2's planes and -0 at (1, 30) id 800.
    The TPU kernel's cross-slot jnp.min orders -0 below +0, so its z is -0
    where some slot's running z is -0 (tiles 0, 1 and 3) and +0 in tile 2.
    K2 and K4 (on the geometry blocks) take entry 10 in every tile, and
    their z is +0 everywhere: their TPU kernels' plane dot accumulates from
    +0. Returns ``(coeffs, counts)`` on ``device``, the winning entries
    ``{kernel: [entry per tile]}`` and the sign bit of K3's z per tile."""
    ties = {0: [(0, 10, 0.0, 600), (0, 20, -0.0, 700)],
            1: [(0, 10, -0.0, 600), (1, 20, 0.0, 500)],
            2: [(0, 10, 0.0, 600), (1, 10, -0.0, 500)],
            3: [(0, 10, 0.0, 600), (1, 10, -0.0, 500), (1, 30, -0.0, 800)]}
    out = tie_tile_blocks(17, c, n_vals, 0.1, 0.8, ties, [3 * c + 44] * 4)
    winners = {"zattr_tiles_vpu": [10, c + 20, 10, 10],
               "zattr_tiles": [10, 10, 10, 10],
               "raster_zid_tiles": [10, 10, 10, 10]}
    return tuple(t.to(device) for t in out), winners, [True, True, False, True]


def zid_tile_inputs(coeffs, counts, n_vals):
    """K4's inputs from K2's and K3's blocks (n_tiles, 3, (5 + n_vals) * K):
    the four geometry blocks (n_tiles, 3, 4K), the constant id plane as
    the slots' triangle ids (n_tiles, K) i32, and the counts."""
    n_tiles = coeffs.shape[0]
    co = coeffs.reshape(n_tiles, 3, 5 + n_vals, -1)
    return (co[:, :, :4].reshape(n_tiles, 3, -1).contiguous(),
            co[:, 2, 4].to(torch.int32).contiguous(), counts)


def synthetic_tile_inputs(device, n_vals=2):
    """K2, K3 and K4's edge cases, made from a seed: 4 tiles of 16x128, K =
    300 entries (not a multiple of the 128-entry chunk, so the padding
    runs), counts (300, 0, 257, 129): an empty tile, a tile whose second
    chunk holds one live entry and 127 scanned entries past its count, and
    dead entries (e0 g = -3e38) throughout. Tile 2 holds one full-tile plane
    at z = -0.99 in entries 5, 9, 130, 200 and 256, with ids that do not
    ascend: K2 takes entry 9 (least id in the first chunk that reaches the
    least z), K3 entry 130 (least id over all lane slots), K4 entry 5 (least
    slot). Returns ``(coeffs (4, 3, (5 + n_vals) * K), coeffs4 (4, 3, 4K),
    ids (4, K) i32, counts (4,) i32)`` on ``device``."""
    g = torch.Generator().manual_seed(5)
    n_tiles, k, th, tw = 4, 300, 16, 128
    r = 5 + n_vals
    co = torch.zeros((n_tiles, 3, r, k))
    ang = torch.rand(n_tiles, 3, k, generator=g) * 6.2832
    cx = torch.rand(n_tiles, 3, k, generator=g) * tw
    cy = torch.rand(n_tiles, 3, k, generator=g) * th
    for e in range(3):
        a, b = torch.cos(ang[:, e]), torch.sin(ang[:, e])
        co[:, 0, e], co[:, 1, e] = a, b
        co[:, 2, e] = -(a * cx[:, e] + b * cy[:, e])
    co[:, 0, 3] = (torch.rand(n_tiles, k, generator=g) - 0.5) * 1e-3
    co[:, 1, 3] = (torch.rand(n_tiles, k, generator=g) - 0.5) * 1e-2
    co[:, 2, 3] = torch.rand(n_tiles, k, generator=g) * 1.6 - 0.8
    ids = torch.randperm(n_tiles * k, generator=g).reshape(n_tiles, k)
    ids = torch.sort(ids, dim=1).values.to(torch.int32)
    co[:, :, 5:] = torch.randn(n_tiles, 3, n_vals, k, generator=g)
    dead = torch.arange(k) % 7 == 3
    co[:, :2, 0, dead] = 0.0
    co[:, 2, 0, dead] = -3.0e38
    tie = (5, 9, 130, 200, 256)
    co[2, :, :4, list(tie)] = 0.0
    co[2, 2, :3, list(tie)] = 1.0  # covers the whole tile
    co[2, 2, 3, list(tie)] = -0.99  # nearer than every random plane
    ids[2, list(tie)] = torch.tensor([5050, 5040, 5030, 5060, 5070],
                                     dtype=torch.int32)
    co[:, 2, 4] = ids.to(torch.float32)  # the constant id plane
    counts = torch.tensor([300, 0, 257, 129], dtype=torch.int32)
    coeffs4 = co[:, :, :4].reshape(n_tiles, 3, 4 * k)
    out = (co.reshape(n_tiles, 3, r * k), coeffs4, ids, counts)
    return tuple(t.contiguous().to(device) for t in out)


def same_bits(a, b) -> bool:
    """Whether two tensors hold the same bits (torch.equal counts -0 equal
    to +0, and a NaN unequal to itself)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def k1_against_plain(gc, inputs, dims) -> float:
    """Kernel and plain version on the same card inputs; raises unless z,
    id and vals are bitwise equal. Returns the max abs difference."""
    got = gc.gbuffer_tiles(*inputs, *dims)
    torch.cuda.synchronize()
    want = gc.gbuffer_tiles_plain(*inputs, *dims)
    err = 0.0
    for name, a, b in zip(("z", "id", "vals"), got, want):
        same = same_bits(a, b)
        fin = torch.isfinite(a.float()) & torch.isfinite(b.float())
        d = (a.float() - b.float()).abs()[fin]
        err = max(err, float(d.max()) if d.numel() else 0.0)
        if not same:
            raise AssertionError(f"K1 {name} differs from the plain version "
                                 f"(max abs {err})")
    return err


def relaid_runs(start, nch):
    """The same live chunks of each view re-laid in list order, at most
    ceil(live / tiles) to a tile: new start_chunks and n_chunks, nothing
    else. The runs K1 is given are packed from chunk 0 (start = exclusive
    cumsum of n), so the re-laid runs cover the same chunks."""
    n_tiles = nch.shape[1]
    live = nch.sum(1, keepdim=True)
    per = (live + n_tiles - 1) // n_tiles
    t = torch.arange(n_tiles, device=nch.device)
    n = torch.minimum((live - t * per).clamp(min=0), per).to(torch.int32)
    return (torch.cumsum(n, 1) - n).to(torch.int32).contiguous(), n.contiguous()


def k1_balance(gc, inputs, dims, card, what) -> tuple:
    """K1 on its inputs as laid and on the same live chunks re-laid evenly
    over the tiles (``relaid_runs``): if the even run is much faster, the
    tile of most chunks sets the launch's time. Returns both times."""
    recs, ids, start, nch = inputs
    even = (recs, ids, *relaid_runs(start, nch))
    ms = cuda_ms(lambda: gc.gbuffer_tiles(*inputs, *dims), 50)
    ms_even = cuda_ms(lambda: gc.gbuffer_tiles(*even, *dims), 50)
    log("k1", f"balance ({what}, {card}): as laid {ms:.4f} ms (at most "
        f"{int(nch.max())} chunks in a tile, {int(nch.sum())} live), re-laid at "
        f"most {int(even[3].max())} to a tile {ms_even:.4f} ms, ratio "
        f"{ms / ms_even:.3f}")
    return ms, ms_even


def k3_reduction(zc, inputs, dims, card) -> tuple:
    """K3 on workload 1's blocks as given and with every count set to 0,
    which leaves the kernel everything but the scan (the old kernel's
    sub-block loop, barriers and cross-slot reduction). Returns both
    times."""
    co, counts = inputs
    zero = torch.zeros_like(counts)
    ms = cuda_ms(lambda: zc.zattr_tiles_vpu(co, counts, *dims), 20)
    ms0 = cuda_ms(lambda: zc.zattr_tiles_vpu(co, zero, *dims), 20)
    log("k3", f"reduction (workload 1, {card}): counts as given {ms:.4f} ms, "
        f"every count 0 (no scan) {ms0:.4f} ms")
    return ms, ms0


def without_sync(fn):
    """``fn()`` with every device-to-host synchronisation an error, so a
    wrapper that waits on the card fails the run."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def log_occupancy(tag, occ, c) -> None:
    log(tag, f"occupancy: {occ['registers']} registers per thread, "
        f"{occ['shared_bytes']} B shared memory per block (c {c}), "
        f"{occ['blocks_per_sm']} resident blocks of 256 threads per SM")


def sphere_scene(pt, device, views=6, texture=None):
    """Workload 1: the 3,968-triangle UV sphere uv_sphere_mesh(32, 65) and
    bench.py:597's orbit (elevation 20, distance 2.7, fovy 40)."""
    verts, faces, uv = pt.uv_sphere_mesh(32, 65)
    mesh = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                               texture=texture, device=device)
    cam = pt.get_camera(elevation_deg=20.0, distance=2.7, fovy_deg=40.0,
                        num_views=views, near=0.1, far=10.0, device=device)
    return pt.with_normals(mesh), cam


def atlas_clip(mesh):
    """The UV layout as clip positions (1, V, 4), as baking/uv.py:74-82
    builds them."""
    uv = mesh.v_tex * 2.0 - 1.0
    return torch.cat([uv, torch.zeros_like(uv[:, :1]),
                      torch.ones_like(uv[:, :1])], dim=1)[None]


def tile_bound_ms(counts, tile_h, tile_w, chunk, scan_words, out_words,
                  ops_per_row=0, ops_per_col=0):
    """Least time the card could take for a K2, K3 or K4 launch on these
    inputs: the larger of the scanned (entry, pixel) pairs' fp32
    instructions (``TILE_OPS_PER_PAIR``, plus ``ops_per_row`` per entry and
    tile row and ``ops_per_col`` per entry and tile column) over the card's
    fp32 instruction rate and the bytes it must move (each scanned entry's
    scan words read once, the counts read, each output written once) over
    the memory rate. Each tile scans ceil(count / c) chunks of c entries."""
    from worldrenderer_tpu_torch.ops.tensor import chunk_size

    c = chunk_size(chunk)
    live = int(((counts.long().clamp(min=0) + (c - 1)) // c).sum())
    p = tile_h * tile_w
    ops = live * c * (p * TILE_OPS_PER_PAIR + tile_h * ops_per_row
                      + tile_w * ops_per_col)
    ops_ms = ops / PEAK_FP32_INSTR * 1e3
    n_tiles = counts.numel()
    nbytes = live * c * scan_words * 4 + n_tiles * 4 + n_tiles * p * out_words * 4
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", live
    return bytes_ms, "bytes", live


def bitwise_against_plain(what, got, want) -> float:
    """Raises unless every output pair is bitwise equal; returns the max
    abs difference over finite values."""
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got, want):
        fin = torch.isfinite(a.float()) & torch.isfinite(b.float())
        d = (a.float() - b.float()).abs()[fin]
        err = max(err, float(d.max()) if d.numel() else 0.0)
        if not same_bits(a, b):
            raise AssertionError(f"{what} differs from the plain version "
                                 f"(max abs {err})")
    return err


def zero_sign_check(kernel, plain, dev) -> None:
    """K3 on ``zero_sign_tile_inputs``: ids and values bitwise equal to the
    plain version, z equal in value, and z's sign that of the TPU kernel's
    cross-slot jnp.min (-0 where any slot's running z is -0). The plain
    version's torch.amin leaves that sign to its reduction order, so z's
    bits are held to the TPU kernel's rule here, not to the plain
    version."""
    (co, counts), winners, signs = zero_sign_tile_inputs(dev)
    dims = (2, 16, 128, 128)
    got = kernel(co, counts, *dims)
    want = plain(co, counts, *dims)
    bitwise_against_plain("zattr_tiles_vpu", got[1:], want[1:])
    k = co.shape[2] // 7
    tid = co.reshape(4, 3, 7, k)[:, 2, 4]
    win = torch.tensor(winners["zattr_tiles_vpu"], device=dev)
    want_ids = tid[torch.arange(4, device=dev), win]
    if not (torch.equal(got[0], want[0]) and (got[0] == 0).all()
            and torch.equal(got[1], want_ids[:, None, None].expand_as(got[1]))):
        raise AssertionError("zattr_tiles_vpu zero_signs: wrong z or winners")
    neg = torch.signbit(got[0]).flatten(1)
    for t, sign in enumerate(signs):
        if not (neg[t] == sign).all():
            raise AssertionError(f"zattr_tiles_vpu zero_signs: tile {t}'s z is "
                                 f"not {'-0' if sign else '+0'}")
    plain_neg = torch.signbit(want[0]).flatten(1).float().mean(1).tolist()
    log("k3", f"zero_signs: ids and values bitwise equal to the plain version, "
        f"z equal in value; z per tile {['-0' if n else '+0' for n in signs]} "
        f"as the TPU kernel's jnp.min gives it (the plain version's torch.amin:"
        f" share of -0 per tile {plain_neg})")


# Each kernel's launch counter (``utils.debug.count``): the tile kernels
# K1-K4 and the bake's sampler S1.
KERNEL_COUNTERS = {"gbuffer_tiles": "launch.k1", "zattr_tiles": "launch.k2",
                   "zattr_tiles_vpu": "launch.k3", "raster_zid_tiles": "launch.k4",
                   "grid_sample_bilinear": "launch.s1"}


def reset_counts() -> dict:
    """The launch counters' totals now, for :func:`read_counts`."""
    from worldrenderer_tpu_torch.utils.debug import counter_totals

    return counter_totals()


def read_counts(since: dict) -> dict:
    """Each kernel's launches after the totals ``since``."""
    from worldrenderer_tpu_torch.utils.debug import counter_totals

    torch.cuda.synchronize()
    now = counter_totals()
    return {name: now.get(c, 0) - since.get(c, 0)
            for name, c in KERNEL_COUNTERS.items()}


def only(**launches) -> dict:
    """What :func:`read_counts` reads where only ``launches`` ran."""
    return {name: launches.get(name, 0) for name in KERNEL_COUNTERS}


def tile_winners_check(what, got_ids, inputs, n_vals, winners, plus_one) -> None:
    """Raises unless each tile's ids are those of its winning entry
    (``winners``, one per tile, spanning the whole tile): the constant id
    plane's value, or for K4 the slot's triangle id + 1."""
    co = inputs[0]
    dev = co.device
    if plus_one:  # K4: (coeffs4, ids, counts)
        tid = inputs[1].to(torch.float32) + 1
    else:
        k = co.shape[2] // (5 + n_vals)
        tid = co.reshape(co.shape[0], 3, 5 + n_vals, k)[:, 2, 4]
    rows = torch.arange(tid.shape[0], device=dev)
    want = tid[rows, torch.tensor(winners, device=dev)]
    if not torch.equal(got_ids.to(torch.float32),
                       want[:, None, None].expand_as(got_ids)):
        raise AssertionError(f"{what}: wrong tie winners")


def plus_zero_check(tag, name, got) -> None:
    """K2 or K4 on ``zero_sign_tile_inputs``, whose every pixel is covered
    at z = 0: every z must be +0, as the TPU kernels' plane dot gives it."""
    z = got[0]
    if not ((z == 0).all() and not torch.signbit(z).any()):
        raise AssertionError(f"{name} zero_signs: a covered z is not +0")
    log(tag, "zero_signs: every covered z is +0 (the planes at zero are +0 "
        "and -0; the TPU kernel's plane dot accumulates from +0)")


def k2_k4_times(zc, rk, zin, zdims, kin, atlas, kdims, card) -> dict:
    """K2 on workload 1's blocks and K4 on workload 1's and the atlas's,
    through their wrappers, as given and with every count 0: then no tile
    scans a chunk, the grid's blocks that a tile does not need exit at once
    and the rest write the background, so the second time is what the grid
    costs without the scan. Each wrapper launches one CUDA kernel (an
    older K4 wrapper also mapped the kernel's slots to ids in PyTorch, so
    a parent's K4 reads with that gather). Returns the times."""
    def zero(counts):
        return torch.zeros_like(counts)

    def k4(inputs, counts):
        return lambda: rk.raster_zid_tiles(inputs[0], inputs[1], counts, *kdims)

    t = {"k2": cuda_ms(lambda: zc.zattr_tiles(*zin, *zdims), 20),
         "k2_empty": cuda_ms(
             lambda: zc.zattr_tiles(zin[0], zero(zin[1]), *zdims), 20),
         "k4": cuda_ms(k4(kin, kin[2]), 20),
         "k4_empty": cuda_ms(k4(kin, zero(kin[2])), 20),
         "k4_atlas": cuda_ms(k4(atlas, atlas[2]), 20),
         "k4_atlas_empty": cuda_ms(k4(atlas, zero(atlas[2])), 20)}
    log("k2", f"every count 0 (workload 1, {card}): {t['k2_empty']:.4f} ms "
        f"against {t['k2']:.4f} ms as given")
    log("k4", f"every count 0 ({card}): workload 1 {t['k4_empty']:.4f} ms "
        f"against {t['k4']:.4f} ms as given; atlas {t['k4_atlas_empty']:.4f} "
        f"ms against {t['k4_atlas']:.4f} ms")
    return t


def tile_kernel_checks(pt, gb, pr, zc, rk, dev, card) -> dict:
    """Phase 3 for K2, K3 and K4: each kernel against its plain version on
    the card, bit for bit, at the slice's shapes (workload 1's per-tile
    blocks; for K4 also workload 2's 2048² atlas) and on the synthetic edge
    cases; then each kernel's time, its plain version's and its bound at
    workload 1's shapes, every count 0, a run with device-to-host syncs an
    error, and its registers and blocks per SM. Returns the kernels' JSON
    entries (launches still 0)."""
    from worldrenderer_tpu_torch.ops.tensor import chunk_size

    mesh, cam = sphere_scene(pt, dev)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    cfg = pt.DEFAULT_CONFIG
    zin, zdims, _ = gb._zattr_inputs(pos, mesh.t_pos_idx, mesh.v_nrm, 512, 512,
                                     cfg)
    kin = pr._zid_inputs(pos, mesh.t_pos_idx, 512, 512, cfg)[1]
    atlas = pr._zid_inputs(atlas_clip(mesh), mesh.t_tex_idx, 2048, 2048, cfg)[1]
    kdims = (cfg.tile_h, cfg.tile_w, cfg.chunk)
    co, co4, ids, counts = synthetic_tile_inputs(dev)
    sdims = (2, 16, 128, 128)
    ties, winners = slot_tie_tile_inputs(dev)
    ties256, winners256 = slot_tie_tile_inputs(dev, c=256)
    zeros, zwinners, _ = zero_sign_tile_inputs(dev)
    times = k2_k4_times(zc, rk, zin, zdims, kin, atlas, kdims, card)
    entries = {}
    for name, tag, src, replaces in (
        ("zattr_tiles", "k2", "zattr_tiles.cu", "gbuffer_pallas.py:290"),
        ("zattr_tiles_vpu", "k3", "zattr_tiles.cu", "gbuffer_pallas.py:209"),
    ):
        kernel = getattr(zc, name)
        plain = getattr(zc, f"{name}_plain")
        err = 0.0
        cases = [("sphere_512", zin, zdims, None),
                 ("synthetic", (co, counts), sdims, None),
                 ("synthetic_w96", (co, counts), (2, 16, 96, 128), None),
                 ("synthetic_c256", (co, counts), sdims[:3] + (256,), None),
                 ("slot_ties", ties, sdims, winners[name]),
                 ("slot_ties_c256", ties256, sdims[:3] + (256,), winners256[name]),
                 ("synthetic_64x128", (co, counts), (2, 64, 128, 128), None)]
        if name == "zattr_tiles":  # K3's zero signs follow its slot rule
            cases.append(("zero_signs", zeros, sdims, zwinners[name]))
        for case, inputs, dims, win in cases:
            got = kernel(*inputs, *dims)
            e = bitwise_against_plain(name, got, plain(*inputs, *dims))
            err = max(err, e)
            if win is not None:
                tile_winners_check(f"{name} {case}", got[1], inputs, dims[0],
                                   win, False)
            log(tag, f"{case}: {int(inputs[0].shape[0])} tiles, bitwise equal "
                f"to the plain version (max abs err {e})")
            if case == "zero_signs":
                plus_zero_check(tag, name, got)
        if name == "zattr_tiles_vpu":
            zero_sign_check(kernel, plain, dev)
            ms = cuda_ms(lambda: kernel(*zin, *zdims), 20)
            ops = {"ops_per_row": OPS_PER_ENTRY_ROW}
        else:
            ms = times["k2"]
            ops = {"ops_per_col": OPS_PER_ENTRY_COL}
        plain_ms = cuda_ms(lambda: plain(*zin, *zdims), 2)
        bound, by, live = tile_bound_ms(zin[1], zdims[1], zdims[2], zdims[3],
                                        13, 2 + zdims[0], **ops)
        log(tag, f"workload 1 ({card}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound:.5f} ms by {by} ({live} live chunks)")
        if name == "zattr_tiles_vpu":
            k3_reduction(zc, zin, zdims, card)
        without_sync(lambda: kernel(*zin, *zdims))
        log("sync", f"{tag.upper()}'s wrapper ran under "
            "set_sync_debug_mode('error'): no device-to-host sync")
        occ = zc.vpu_occupancy if name == "zattr_tiles_vpu" else zc.occupancy
        log_occupancy(tag, occ(zdims[3], zdims[2]), zdims[3])
        entries[name] = dict(
            name=name, route="cuda", source=f"worldrenderer_tpu_torch/csrc/{src}",
            replaces=f"worldrenderer_tpu/ops/{replaces}", launches=0,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None)

    err = 0.0
    c4dims = (16, 128, 128)
    for case, inputs, dims, win in (
            ("sphere_512", kin, kdims, None),
            ("atlas_2048", atlas, kdims, None),
            ("synthetic", (co4, ids, counts), c4dims, None),
            ("synthetic_64x128", (co4, ids, counts), (64, 128, 128), None),
            ("slot_ties", zid_tile_inputs(*ties, 2), c4dims,
             winners["raster_zid_tiles"]),
            ("zero_signs", zid_tile_inputs(*zeros, 2), c4dims,
             zwinners["raster_zid_tiles"])):
        coeffs, kids, cnt = inputs
        z, slot = rk.raster_zid_tiles_plain(coeffs, cnt, *dims)
        got = rk.raster_zid_tiles(*inputs, *dims)
        e = bitwise_against_plain("raster_zid_tiles", got,
                                  (z, rk.ids_from_slots(slot, kids)))
        err = max(err, e)
        if win is not None:
            tile_winners_check(f"raster_zid_tiles {case}", got[1], inputs, 0,
                               win, True)
        log("k4", f"{case}: {int(coeffs.shape[0])} tiles, bitwise equal to the "
            f"plain version (max abs err {e})")
        if case == "zero_signs":
            plus_zero_check("k4", "raster_zid_tiles", got)
    plain_ms = cuda_ms(lambda: rk.raster_zid_tiles_plain(kin[0], kin[2], *kdims), 2)
    col = {"ops_per_col": OPS_PER_ENTRY_COL}
    bound, by, live = tile_bound_ms(kin[2], *kdims, 12, 2, **col)
    a_bound, a_by, a_live = tile_bound_ms(atlas[2], *kdims, 12, 2, **col)
    log("k4", f"workload 1 ({card}): {times['k4']:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.5f} ms by {by} ({live} live "
        f"chunks); workload 2 atlas {times['k4_atlas']:.4f} ms, bound "
        f"{a_bound:.5f} ms by {a_by} ({a_live} live chunks)")
    without_sync(lambda: rk.raster_zid_tiles(*kin, *kdims))
    log("sync", "K4's wrapper ran under set_sync_debug_mode('error'): no "
        "device-to-host sync")
    log_occupancy("k4", rk.occupancy(kdims[2], kdims[1]), chunk_size(kdims[2]))
    entries["raster_zid_tiles"] = dict(
        name="raster_zid_tiles", route="cuda",
        source="worldrenderer_tpu_torch/csrc/raster_zid_tiles.cu",
        replaces="worldrenderer_tpu/ops/rasterize_pallas.py:97", launches=0,
        max_abs_err=err, ms=times["k4"], plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None)
    return entries


# The views [tiles] and [attr] hold against the port's CPU run: view 0
# alone, which keeps the whole script within 300 s beside the bake phases
# and their CPU runs.
CPU_VIEWS = [0]
# The town's frames held against the CPU (of the 8 rendered).
TOWN_CPU_FRAMES = [0, 4]


def tiles_phase(pt, gc, zc, rk, dev, card) -> dict:
    """Workload 1, 6 views of the UV sphere at 512², with each backend
    through the entry point that reaches its kernel: ``render`` (fused
    branch, K2) for fused_pallas, ``rasterize_gbuffer`` (K3) for
    vpu_pallas — ``render`` sends vpu_pallas to its classic branch, as the
    JAX package's does — and ``render`` (classic branch: K4, then
    interpolate) for pallas. Each run's launch counts and views/s. (Their
    card-vs-CPU comparisons are held elsewhere since the slice 10 phases
    took the time: K2's render path by [attr] and [flat], K3's by [flat],
    K4's by [attr], [classic] and [diff].)"""
    mesh, cam = sphere_scene(pt, dev)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    kw = dict(render_attr=False, render_depth=True, render_normal=True)
    launches = {}
    for backend, kernel in (("fused_pallas", "zattr_tiles"),
                            ("vpu_pallas", "zattr_tiles_vpu"),
                            ("pallas", "raster_zid_tiles")):
        cfg = pt.RasterizerConfig(backend=backend)
        if backend == "vpu_pallas":
            def run(cfg=cfg):
                return pt.rasterize_gbuffer(pos, mesh.t_pos_idx, mesh.v_nrm,
                                            (512, 512), cfg, device=dev)
            entry = "rasterize_gbuffer"
        else:
            def run(cfg=cfg):
                return pt.render(mesh, cam, 512, 512, raster_config=cfg,
                                 device=dev, **kw)
            entry = "render"
        since = reset_counts()
        out = run()
        counts = read_counts(since)
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
        if counts[kernel] < 1:
            raise AssertionError(f"{entry} with {backend} did not launch {kernel}")
        fg = int(out.mask.sum())
        ms = cuda_ms(run, 10)
        log("tiles", f"{backend} via {entry}: launches {counts}; foreground "
            f"{fg}; {ms:.4f} ms = {len(cam) / (ms / 1e3):.2f} views/s ({card})")
        vals = out.z if entry == "rasterize_gbuffer" else out.pos
        if not (fg > len(cam) * 200_000 and torch.isfinite(vals[out.mask]).all()):
            raise AssertionError(f"workload 1 with {backend}: empty or "
                                 "non-finite output")
    return launches


def atlas_phase(pt, gc, zc, rk, dev, card) -> int:
    """Workload 2: the bake's UV-atlas pass (baking/uv.py:99-103) at 2048²:
    ``rasterize`` of the UV layout, then ``interpolate`` of the world
    positions. K4's launches, the card against the port's CPU run at 512²,
    and the pass's time."""
    mesh, _ = sphere_scene(pt, dev, views=1)
    clip4 = atlas_clip(mesh)

    def run(size=2048, m=mesh, c=clip4, d=dev):
        rast = pt.rasterize(c, m.t_tex_idx, (size, size), device=d)
        return rast, pt.interpolate(m.v_pos[None], rast, m.t_pos_idx, device=d)

    since = reset_counts()
    rast, uv_pos = run()
    counts = read_counts(since)
    if counts["raster_zid_tiles"] < 1:
        raise AssertionError("the atlas pass did not launch K4")
    cover = float((rast[..., 3] > 0).float().mean())
    small = run(512)
    ref = run(512, mesh.to("cpu"), clip4.cpu(), "cpu")
    id_diff = int((small[0][..., 3].cpu() != ref[0][..., 3]).sum())
    rast_err = float((small[0].cpu() - ref[0]).abs().max())
    pos_err = float((small[1].cpu() - ref[1]).abs().max())
    ms = cuda_ms(run, 5)
    log("atlas", f"2048²: launches {counts}, coverage {cover:.4f}, finite "
        f"{bool(torch.isfinite(uv_pos).all())}; 512² vs the port on the CPU: "
        f"tri_id diff {id_diff}, rast max abs {rast_err}, pos max abs "
        f"{pos_err}; pass {ms:.4f} ms ({card})")
    fg = int((ref[0][..., 3] > 0).sum())
    if not (id_diff <= 1e-4 * fg and rast_err < 5e-4 and pos_err < 1e-4
            and cover > 0.9 and torch.isfinite(uv_pos).all()):
        raise AssertionError("the atlas pass disagrees with the CPU")
    return counts["raster_zid_tiles"]


def classic_phase(pt, gc, zc, rk, dev, card) -> int:
    """Workload 3: ``rasterize`` and ``rasterize_db`` of the headline
    heightfield (10,082 triangles, 6 views at 512²), the flat path: K1 in
    uv mode. Launch counts, and the card against the port's CPU run of
    views 0 and 3."""
    mesh, cam = headline_scene(pt, dev)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    tri = mesh.t_pos_idx
    k1 = 0
    outs = {}
    for name, fn in (("rasterize", pt.rasterize), ("rasterize_db", pt.rasterize_db)):
        since = reset_counts()
        outs[name] = fn(pos, tri, (512, 512), device=dev)
        counts = read_counts(since)
        if counts["gbuffer_tiles"] < 1:
            raise AssertionError(f"{name} did not launch K1")
        k1 += counts["gbuffer_tiles"]
        log("classic", f"{name}: launches {counts}")
    rast = outs["rasterize"][CPU_VIEWS].cpu()
    rast_db, db = (t[CPU_VIEWS].cpu() for t in outs["rasterize_db"])
    ref = pt.rasterize(pos[CPU_VIEWS].cpu(), tri.cpu(), (512, 512), device="cpu")
    _, ref_db = pt.rasterize_db(pos[CPU_VIEWS].cpu(), tri.cpu(), (512, 512),
                                device="cpu")
    fg = int((ref[..., 3] > 0).sum())
    same = rast[..., 3] == ref[..., 3]
    id_diff = int((~same).sum())
    uvz_err = float((rast - ref)[same].abs().max())
    db_err = float((db - ref_db)[same].abs().max())
    both_equal = bool(torch.equal(rast, rast_db))
    ms = cuda_ms(lambda: pt.rasterize(pos, tri, (512, 512), device=dev), 10)
    log("classic", f"vs the port on the CPU (view 0): tri_id diff {id_diff} "
        f"of {fg}, rast max abs {uvz_err}, rast_db max abs {db_err}; "
        f"rasterize_db's rast equals rasterize's: {both_equal}; rasterize "
        f"{ms:.4f} ms = {len(cam) / (ms / 1e3):.2f} views/s ({card})")
    if not (id_diff <= 1e-4 * fg and uvz_err < 5e-4 and db_err < 5e-4
            and both_equal and fg > 50_000):
        raise AssertionError("classic rasterize disagrees with the CPU")
    return k1


def flat_backends_phase(pt, gb, gc, zc, rk, dev, card, head_cfg, early) -> dict:
    """The headline heightfield (6 views at 512², normals, the headline's
    budgets) through ``rasterize_gbuffer`` with ``vpu_pallas`` and
    ``fused_xla``: at 10,082 triangles the JAX package runs these on tile
    rows cut from its flat binning, through its K3 and through
    ``_zattr_tile_xla`` (K2's contract), and so does the port. Each run's
    launch counts (K1 none), K3 / K2 on those rows bitwise against their
    plain versions, the card against the port's CPU run of view 0 (mask and
    tri_id within 1e-4 of the foreground, z 1e-5, attributes 5e-4; the
    CPU's run is flat_cpu_ref's, in the early CpuReferences) and views/s.
    Returns the launches."""
    mesh, cam = headline_scene(pt, dev)
    mesh = pt.with_normals(mesh)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    tri, nrm = mesh.t_pos_idx, mesh.v_nrm
    launches = {}
    for backend, kernel in (("vpu_pallas", "zattr_tiles_vpu"),
                            ("fused_xla", "zattr_tiles")):
        cfg = head_cfg._replace(backend=backend)

        def run(cfg=cfg):
            return pt.rasterize_gbuffer(pos, tri, nrm, (512, 512), cfg,
                                        device=dev)

        since = reset_counts()
        out = run()
        counts = read_counts(since)
        if counts[kernel] < 1 or counts["gbuffer_tiles"]:
            raise AssertionError(f"rasterize_gbuffer with {backend} did not "
                                 f"run {kernel} alone: {counts}")
        launches[kernel] = counts[kernel]
        inputs, dims, _ = gb._zattr_inputs(pos, tri, nrm, 512, 512, cfg)
        err = bitwise_against_plain(
            kernel, getattr(zc, kernel)(*inputs, *dims),
            getattr(zc, f"{kernel}_plain")(*inputs, *dims))
        ref = early.result("flat")[backend]
        fg = int(ref.mask.sum())
        both = out.mask[:1].cpu() & ref.mask
        diffs = {"mask": int((out.mask[:1].cpu() != ref.mask).sum()),
                 "tri_id": int((out.tri_id[:1].cpu() != ref.tri_id).sum())}
        errs = {"z": float((out.z[:1].cpu() - ref.z)[both].abs().max()),
                "attr": float((out.attr[:1].cpu() - ref.attr)[both].abs().max())}
        ms = cuda_ms(run, 10)
        log("flat", f"{backend}: launches {counts}; {kernel} on the flat rows "
            f"({int(inputs[0].shape[0])} tiles, K {inputs[0].shape[2] // (5 + dims[0])}"
            f", {int(inputs[1].sum())} entries) bitwise equal to the plain "
            f"version (max abs err {err}); view 0 vs the port on the CPU: "
            f"{diffs} of {fg} foreground, {errs}; {ms:.4f} ms = "
            f"{len(cam) / (ms / 1e3):.2f} views/s ({card})")
        if not (max(diffs.values()) <= 1e-4 * fg and errs["z"] < 1e-5
                and errs["attr"] < 5e-4 and fg > 50_000):
            raise AssertionError(f"the flat path with {backend}: the card "
                                 "disagrees with the CPU")
    return launches


def normals_check(pt, meshes, dev, nrm_err) -> None:
    """The vertex normals' steps on the card against the CPU on the same
    inputs, bit for bit, for each (name, mesh): the face normals
    (``transforms.cross``), ``compute_vertex_normals``, and ``normalize``
    of the vertex sums; any element apart fails. Beside it, the rendered
    headline normals' largest card-against-CPU difference."""
    from worldrenderer_tpu_torch import mesh as pm
    from worldrenderer_tpu_torch.transforms import cross

    def face_normals(v, t):
        return cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])

    parts = []
    for name, mesh in meshes:
        v_c, t_c = mesh.v_pos.cpu(), mesh.t_pos_idx.cpu()
        fn_c = face_normals(v_c, t_c)
        sums = pm._sum_to_vertices(fn_c, t_c, len(v_c))
        apart = {
            "cross": bits_differ(face_normals(v_c.to(dev), t_c.to(dev)), fn_c),
            "compute_vertex_normals": bits_differ(
                pt.compute_vertex_normals(v_c.to(dev), t_c.to(dev)),
                pt.compute_vertex_normals(v_c, t_c)),
            "normalize": bits_differ(pt.normalize(sums.to(dev)), pt.normalize(sums)),
        }
        parts.append(f"{name} ({len(v_c)} vertices) {apart}")
        if any(apart.values()):
            raise AssertionError(f"{name}: the card's vertex normals differ from "
                                 f"the CPU's: {apart}")
    log("normals", f"card vs CPU, elements apart: {'; '.join(parts)}; rendered "
        f"headline normals card vs CPU max abs {nrm_err} (0: {nrm_err == 0})")


def spread_report(pt, mesh, cam, dev, kw, out, ref) -> None:
    """Where the card's render parts from the CPU's. Normals: the vertex
    normals against the CPU's and against a second card run, then the
    card's render given the CPU's vertex normals, and two card renders
    against each other. Positions: the batched inverse MVP of the two
    devices."""

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


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm, MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def checker(size, period):
    """bench.py's checker texture: (size, size, 3), squares of ``period``
    texels, quantized to k/255."""
    t = (np.indices((size, size)).sum(0) // period % 2).astype(np.float32)
    return np.round(np.stack([t, 1 - t, t * 0 + 0.5], -1) * 255) / 255


def config4_scene(pt, device, split=False):
    """bench.py:684's config4: the 10,082-triangle heightfield with planar
    UVs, a 1024² checker of 64-texel squares (k/255) and 4 views at
    elevation 35, distance 3, fovy 50. ``split``: bench.py:749-784's
    split-UV topology (the middle column's UVs duplicated for the faces to
    its right)."""
    n = 72
    verts, faces = pt.make_grid_mesh(
        n, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y))
    uv = (verts[:, :2] - verts[:, :2].min(0)) / np.ptp(verts[:, :2], 0)
    v_tex, t_tex = uv, faces
    if split:
        col = np.arange(n * n) % n
        mid = np.where(col == n // 2)[0]
        v_tex = np.concatenate([uv, uv[mid]], axis=0)
        alt = np.arange(n * n)
        alt[mid] = n * n + np.arange(mid.size)
        right = col[faces].max(axis=1) > n // 2
        t_tex = np.where(right[:, None], alt[faces], faces)
    mesh = pt.mesh_from_arrays(verts, faces, v_tex=v_tex, t_tex_idx=t_tex,
                               texture=checker(1024, 64), device=device)
    cam = pt.get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                        num_views=4, near=0.1, far=10.0, device=device)
    return mesh, cam


def config4_cfg(pt, mesh, cam):
    """bench.py:248-256's sizing: auto_fast_config on FAST_TPU_CONFIG."""
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    return pt.auto_fast_config(pos, mesh.t_pos_idx, (1024, 1024),
                               base=pt.FAST_TPU_CONFIG)


def textured_kernel_inputs(pt, gb, dev):
    """K1 and K2 at slice 3's widths: config4's flat-path inputs at 1024²
    with normals and (u, v) as attributes (n_vals 6), and workload 1's
    per-tile inputs with normals, tangents and (u, v) (n_vals 9)."""
    mesh, cam = config4_scene(pt, dev)
    mesh = pt.with_normals(mesh)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    cfg = config4_cfg(pt, mesh, cam)
    k1 = gb._k1_inputs(pos, mesh.t_pos_idx, torch.cat([mesh.v_nrm, mesh.v_tex], -1),
                       1024, 1024, cfg, pos_world=mesh.v_pos,
                       mvp=cam.mvp_mtx)[:2]
    sph, scam = sphere_scene(pt, dev)
    sph = pt.with_normals(sph, compute_tangents=True)
    spos = pt.get_clip_space_position(sph.v_pos, scam.mvp_mtx)
    k2 = gb._zattr_inputs(spos, sph.t_pos_idx,
                          torch.cat([sph.v_nrm, sph.v_tang, sph.v_tex], -1),
                          512, 512, pt.DEFAULT_CONFIG)[:2]
    return k1, k2


def probe_times(p1, p3, head, dims, dev) -> dict:
    """P1's and P3's times, each through its wrapper with CUDA events over
    back-to-back calls and its kernel alone from a torch.profiler trace
    (None where the trace holds no such kernel): P1 on ``head``'s chunk
    runs, P3 on both axes at R 2048, T 400."""
    def p1_call():
        return p1.chunk_stream(*head, *dims)

    t = {"p1": cuda_ms(p1_call, 50),
         "p1_kernel": kernel_device_ms(p1_call, "chunk_stream_kernel")}
    for axis in (1, 0):
        xs, idx = p3.probe_inputs(axis, dev)

        def call(xs=xs, idx=idx, axis=axis):
            return p3.smem_gather(xs, idx, p3.T, axis)

        t[f"p3_axis{axis}"] = cuda_ms(call, 10)
        t[f"p3_axis{axis}_kernel"] = kernel_device_ms(
            call, f"gather_axis{axis}_kernel", 10)
        # T = 0: what a launch costs besides its loads (staging the window,
        # the indices and outputs, axis 0's pairing).
        t[f"p3_axis{axis}_t0_kernel"] = kernel_device_ms(
            lambda: p3.smem_gather(xs, idx, 0, axis), f"gather_axis{axis}_kernel",
            10)
    return t


def probe_checks(head_k1, head_dims, dev, card) -> dict:
    """Phase 3 for P1-P3: each probe kernel against its plain version on
    the card, bit for bit: P1 at the TPU probe's case, at the headline's K1
    chunk runs over a (6, 8, L) array, with every count 0, on runs longer
    than its register group and at c = 256 and 32; P2 at V 6, R 24, N
    999,699; P3 at R 2048, T 400, both axes, and where its indices wrap (R
    300 from M - 1 and from 0, R 5 and 37). Then times, bounds and library
    calls: P1's and P3's kernels alone from a torch.profiler trace beside
    their wrappers' times with CUDA events, an empty launch's beside them,
    and each P3 kernel's registers and blocks per SM. Returns the kernels'
    JSON entries (launches still 0)."""
    from worldrenderer_tpu_torch.probes import chunk_stream as p1
    from worldrenderer_tpu_torch.probes import smem_gather as p3
    from worldrenderer_tpu_torch.probes import transpose as p2

    entries = {}
    g = torch.Generator(device=dev).manual_seed(11)

    # P1: the probe's own case, the headline's chunk runs, edge cases.
    own = (torch.arange(2 * 8 * 1024, dtype=torch.float32, device=dev)
           .reshape(2, 8, 1024) * 1e-4,
           torch.tensor([[0, 2, 4, 6], [1, 3, 5, 7]], dtype=torch.int32, device=dev),
           torch.tensor([[2, 2, 2, 0], [1, 1, 1, 1]], dtype=torch.int32, device=dev))
    _, _, start, nch = head_k1
    _, th, tw, n_ty, n_tx, c = head_dims[:6]
    dims = (n_ty * n_tx, th, tw, c)
    x = torch.randn((start.shape[0], 8, head_k1[0].shape[2]), generator=g,
                    device=dev)
    head = (x, start, nch)
    runs = torch.bincount(nch.flatten().long()).tolist()
    log("probes", f"P1 headline run lengths (chunks: tiles): "
        f"{ {n: k for n, k in enumerate(runs) if k} }")
    long_x = torch.rand((2, 8, 40 * 256), generator=g, device=dev)
    long_s = torch.randint(0, 20, (2, 5), generator=g, device=dev,
                           dtype=torch.int32)
    long_n = torch.randint(9, 15, (2, 5), generator=g, device=dev,
                           dtype=torch.int32)
    err = 0.0
    for case, (xx, ss, nn), dd in (
            ("probe_own", own, (4, 16, 128, 128)),
            ("headline_runs", head, dims),
            ("every_count_0", (x, start, torch.zeros_like(nch)), dims),
            ("long_runs", (long_x, long_s, long_n), (5, 8, 64, 128)),
            ("long_runs_c256", (long_x, long_s, long_n), (5, 8, 64, 256)),
            ("runs_c32", (long_x, long_s, long_n), (5, 7, 61, 32))):
        e = bitwise_against_plain("chunk_stream", [p1.chunk_stream(xx, ss, nn, *dd)],
                                  [p1.chunk_stream_plain(xx, ss, nn, *dd)])
        err = max(err, e)
        log("probes", f"P1 {case}: {int(nn.sum())} live chunks, bitwise equal to "
            f"the plain version (max abs err {e})")
    live = int(nch.sum())

    def p1_library():  # gather each tile's run with one index, then sum
        nmax = int(nch.max())
        j = torch.arange(nmax, device=dev)
        idx = (start.long()[..., None] + j).clamp(max=x.shape[2] // c - 1)
        chunks = x.reshape(x.shape[0], 8, -1, c).permute(0, 2, 1, 3)
        got = chunks[torch.arange(x.shape[0], device=dev)[:, None, None], idx]
        got = got * (j < nch[..., None])[..., None, None]
        acc = got.sum((2, 3, 4))
        return acc[..., None] + torch.arange(th * tw, device=dev, dtype=torch.float32)

    times = probe_times(p1, p3, head, dims, dev)
    wrapper_ms, kernel_ms = times["p1"], times["p1_kernel"]
    empty_ms = cuda_ms(p1.empty_launch, 50)
    empty_dev = kernel_device_ms(p1.empty_launch, "empty_kernel")
    plain_ms = cuda_ms(lambda: p1.chunk_stream_plain(*head, *dims), 3)
    lib_ms = cuda_ms(p1_library, 10)
    nbytes = live * 8 * c * 4 + 2 * start.numel() * 4 + start.numel() * th * tw * 4
    bound = nbytes / PEAK_BYTES * 1e3
    log("probes", f"P1 headline runs ({card}): kernel {kernel_ms} ms on the card "
        f"(profiler), wrapper {wrapper_ms:.4f} ms (CUDA events, back to back); "
        f"an empty launch {empty_dev} ms on the card, {empty_ms:.4f} ms back to "
        f"back; plain {plain_ms:.4f} ms, library (index + sum) {lib_ms:.4f} ms, "
        f"bound {bound:.5f} ms by bytes ({nbytes} B)")
    entries["chunk_stream"] = dict(
        name="chunk_stream", route="cuda",
        source="worldrenderer_tpu_torch/csrc/probe_chunk_stream.cu",
        replaces="tools/spike_dma.py:53", launches=0, max_abs_err=err,
        ms=wrapper_ms if kernel_ms is None else kernel_ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=lib_ms)

    # P2: the TPU probe's record-table shape.
    x3 = torch.randn((p2.V, p2.R, p2.N), generator=g, device=dev)
    e = bitwise_against_plain("transpose", [p2.transpose(x3)],
                              [p2.transpose_plain(x3)])
    ms = cuda_ms(lambda: p2.transpose(x3), 20)
    plain_ms = cuda_ms(lambda: p2.transpose_plain(x3), 5)
    lib_ms = cuda_ms(lambda: x3.transpose(1, 2).contiguous(), 20)
    nbytes = 2 * x3.numel() * 4
    bound = nbytes / PEAK_BYTES * 1e3
    log("probes", f"P2 ({p2.V}, {p2.R}, {p2.N}) bitwise equal to the plain "
        f"version ({card}): {ms:.4f} ms = {nbytes / ms / 1e6:.1f} GB/s, plain "
        f"{plain_ms:.4f} ms, library (transpose + contiguous) {lib_ms:.4f} ms, "
        f"bound {bound:.5f} ms by bytes")
    entries["transpose"] = dict(
        name="transpose", route="cuda",
        source="worldrenderer_tpu_torch/csrc/probe_transpose.cu",
        replaces="tools/probe_transpose.py:89", launches=0, max_abs_err=e, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=lib_ms)
    del x3

    # P3: both axes at R 2048, T 400, then where the indices wrap; the
    # JSON entry is axis 0's (the windowed texture sampler's candidate
    # primitive).
    clock = max_sm_clock_hz()
    loads = p3.T * p3.R * p3.LANES
    bound = loads * 4 / (SMEM_BYTES_PER_CLOCK_SM * N_SMS * clock) * 1e3
    err = 0.0
    for axis, rows, first in ((0, 300, "last"), (0, 300, "zero"), (1, 300, "last"),
                              (1, 300, "zero"), (0, 5, "random"), (1, 5, "random"),
                              (0, 37, "random"), (1, 37, "random")):
        xs, idx = p3.probe_inputs(axis, dev, rows=rows)
        m = rows if axis == 0 else p3.LANES
        if first != "random":
            idx = torch.full_like(idx, m - 1 if first == "last" else 0)
        e = bitwise_against_plain("smem_gather", [p3.smem_gather(xs, idx, p3.T, axis)],
                                  [p3.smem_gather_plain(xs, idx, p3.T, axis)])
        err = max(err, e)
    log("probes", "P3 wraps (T 400; axis 0 and 1 at R 300 from M - 1 and from "
        "0, at R 5 and 37 from random indices): bitwise equal to the plain "
        f"version (max abs err {err})")
    res = {}
    for axis in (1, 0):
        xs, idx = p3.probe_inputs(axis, dev)
        e = bitwise_against_plain("smem_gather", [p3.smem_gather(xs, idx, p3.T, axis)],
                                  [p3.smem_gather_plain(xs, idx, p3.T, axis)])
        ms, dev_ms = times[f"p3_axis{axis}"], times[f"p3_axis{axis}_kernel"]
        # The plain version is the library call: torch.gather and an add, T
        # times.
        plain_ms = cuda_ms(lambda: p3.smem_gather_plain(xs, idx, p3.T, axis), 2)
        res[axis] = (max(e, err), ms if dev_ms is None else dev_ms, plain_ms)
        occ = p3.occupancy(axis)
        log("probes", f"P3 axis {axis} (R {p3.R}, T {p3.T}) bitwise equal to the "
            f"plain version ({card}): kernel {dev_ms} ms on the card (profiler), "
            f"at T 0 {times[f'p3_axis{axis}_t0_kernel']} ms, wrapper {ms:.4f} "
            f"ms ({res[axis][1] * 1e9 / loads:.3f} ps per load), plain = "
            f"library (gather x T) {plain_ms:.4f} ms, "
            f"bound {bound:.5f} ms by shared-memory bytes at {clock / 1e6:.0f} "
            f"MHz ({100 * bound / res[axis][1]:.1f}%); {occ['registers']} "
            f"registers per thread, {occ['shared_bytes']} B shared memory per "
            f"block, {occ['blocks_per_sm']} resident blocks per SM")
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.random((1 << 20, 12)).astype(np.float32)).to(dev)
    rows = torch.from_numpy(rng.integers(0, 1 << 20, (8192,))).to(dev)
    row_ms = cuda_ms(lambda: p3.row_gather(table, rows, 50), 5) / 50
    log("probes", f"P3 baseline: (1M, 12) table row gather of 8192 rows "
        f"{row_ms * 1e3:.3f} us ({row_ms * 1e6 / 8192:.3f} ns per row, {card})")
    e, ms, plain_ms = res[0]
    entries["smem_gather"] = dict(
        name="smem_gather", route="cuda",
        source="worldrenderer_tpu_torch/csrc/probe_smem_gather.cu",
        replaces="tools/probe_vmem_gather.py:30", launches=0,
        max_abs_err=max(res[0][0], res[1][0]), ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by="bytes", library_ms=plain_ms)
    return entries


def probes_phase() -> dict:
    """The probes' own entry points, each one's launches counted."""
    from worldrenderer_tpu_torch.probes import chunk_stream as p1
    from worldrenderer_tpu_torch.probes import smem_gather as p3
    from worldrenderer_tpu_torch.probes import transpose as p2

    from worldrenderer_tpu_torch.utils.debug import counter_totals

    launches = {}
    for name, mod, counter in (("chunk_stream", p1, "launch.p1"),
                               ("transpose", p2, "launch.p2"),
                               ("smem_gather", p3, "launch.p3")):
        before = counter_totals().get(counter, 0)
        if mod.main([]) != 0:
            raise AssertionError(f"the {name} probe failed")
        torch.cuda.synchronize()
        launches[name] = counter_totals().get(counter, 0) - before
        if launches[name] < 1:
            raise AssertionError(f"the {name} probe did not launch its kernel")
        log("probes", f"{name} entry point: launches {launches[name]}")
    return launches


def texture_phase(pt, gb, gc, zc, rk, dev, card) -> int:
    """Config4 three ways through ``render`` (attr, depth, normals at 4 x
    1024²): texture_pack_mode none against the port's CPU run of view 0 (mask and
    tri_id within 1e-4 of the foreground, attr / pos / normal within 1e-4 /
    1e-4 / 5e-4), u8 bit-identical to none on this k/255 texture, and the
    split-UV mesh through render's own seam cut equal to the explicitly
    unified mesh. Each with its K1 launches, views/s and the texture call
    timed alone on the render's (u, v) image; then the stage split and a
    profile of the none render. Returns K1's launches."""
    mesh, cam = config4_scene(pt, dev)
    cfg = config4_cfg(pt, mesh, cam)
    kw = dict(render_attr=True, render_depth=True, render_normal=True)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    uv_img = pt.rasterize_gbuffer(pos, mesh.t_pos_idx, mesh.v_tex, (1024, 1024),
                                  cfg, device=dev).attr
    tex = mesh.texture[None]
    split, _ = config4_scene(pt, dev, split=True)
    runs = {}
    k1 = 0
    for name, m, c, mode in (("none", mesh, cfg, "none"), ("u8", mesh, cfg, "u8"),
                             ("split", split, cfg._replace(backend="auto"), "u8")):
        def run(m=m, c=c, mode=mode):
            return pt.render(m, cam, 1024, 1024, raster_config=c,
                             texture_pack_mode=mode, device=dev, **kw)
        since = reset_counts()
        runs[name] = run()
        counts = read_counts(since)
        if counts["gbuffer_tiles"] < 1:
            raise AssertionError(f"config4 {name} did not launch K1")
        k1 += counts["gbuffer_tiles"]
        ms = cuda_ms(run, 5)
        tex_ms = cuda_ms(lambda: pt.texture(tex, uv_img, pack_mode=mode,
                                            device=dev), 20)
        log("texture", f"config4 {name}: K1 launches {counts['gbuffer_tiles']}, "
            f"{ms:.4f} ms = {len(cam) / (ms / 1e3):.2f} views/s, texture call "
            f"alone {tex_ms:.4f} ms ({card})")
        runs[name + "_ms"] = (ms, tex_ms)

    none, u8 = runs["none"], runs["u8"]
    if not torch.equal(u8.attr, none.attr):
        raise AssertionError("config4 u8 attr differs from none on a k/255 texture")
    unified = pt.render(pt.unify_mesh_uv(split), cam, 1024, 1024, raster_config=cfg,
                        texture_pack_mode="u8", device=dev, **kw)
    for f in ("mask", "attr", "pos", "depth", "normal"):
        if not torch.equal(getattr(runs["split"], f), getattr(unified, f)):
            raise AssertionError(f"config4 split {f} differs from the unified mesh")
    split_vs_none = float((runs["split"].attr - none.attr).abs().max())
    log("texture", "config4: u8 attr bitwise equal to none; split-UV through "
        f"render's seam cut equal to the unified mesh in every channel (attr "
        f"vs the unsplit mesh: max abs {split_vs_none})")

    cpu_mesh, cpu_cam = mesh.to("cpu"), cam[CPU_VIEWS].to("cpu")
    ref = pt.render(cpu_mesh, cpu_cam, 1024, 1024, raster_config=cfg,
                    texture_pack_mode="none", device="cpu", **kw)
    ids = pt.rasterize_gbuffer(pos[CPU_VIEWS], mesh.t_pos_idx, None,
                               (1024, 1024), cfg, device=dev).tri_id.cpu()
    ref_ids = pt.rasterize_gbuffer(pos[CPU_VIEWS].cpu(), cpu_mesh.t_pos_idx,
                                   None, (1024, 1024), cfg, device="cpu").tri_id
    mask_diff, fg, errs = card_vs_cpu(none, ref, CPU_VIEWS,
                                      ("attr", "pos", "normal"))
    id_diff = int((ids != ref_ids).sum())
    log("texture", f"config4 none vs the port on the CPU (view 0): mask diff "
        f"{mask_diff}, tri_id diff {id_diff} of {fg}, {errs}")
    if not (mask_diff <= 1e-4 * fg and id_diff <= 1e-4 * fg and errs["attr"] < 1e-4
            and errs["pos"] < 1e-4 and errs["normal"] < 5e-4 and fg > 250_000
            and torch.isfinite(none.attr).all()):
        raise AssertionError("config4 on the card disagrees with the CPU")

    nm = pt.with_normals(mesh)
    v_attr = torch.cat([nm.v_nrm, nm.v_tex], -1)

    def prep():
        return gb._k1_inputs(pos, nm.t_pos_idx, v_attr, 1024, 1024, cfg,
                             pos_world=nm.v_pos, mvp=cam.mvp_mtx)

    inputs, dims, _ = prep()
    prep_ms = cuda_ms(prep, 5)
    k1_ms = cuda_ms(lambda: gc.gbuffer_tiles(*inputs, *dims), 20)
    ms, tex_ms = runs["none_ms"]
    log("texture", f"config4 none stages ({card}): prep {prep_ms:.4f} ms, K1 "
        f"{k1_ms:.4f} ms, texture {tex_ms:.4f} ms, the rest "
        f"{ms - prep_ms - k1_ms - tex_ms:.4f} ms of {ms:.4f} ms")
    wall, busy, n_kernels, top = profile_ms(
        lambda: pt.render(mesh, cam, 1024, 1024, raster_config=cfg,
                          texture_pack_mode="none", device=dev, **kw))
    if n_kernels:
        log("profile", f"config4 none: {wall:.3f} ms wall, device busy {busy:.3f} "
            f"ms ({100 * (1 - busy / wall):.1f}% idle), {n_kernels:.0f} CUDA "
            "kernels per render")
        for name, t, count in top:
            log("profile", f"{t:8.4f} ms {count:5.0f}x {name}")
    return k1


def attr_variants(pt):
    """[attr]'s renders: (name, kernel, render keywords)."""
    return (("fused+tangent", "zattr_tiles", dict(render_tangent=True)),
            ("classic+antialias", "raster_zid_tiles",
             dict(raster_config=pt.RasterizerConfig(backend="pallas"),
                  render_tangent=True, antialias_attr=True)),
            ("auto_mip", "zattr_tiles", dict(texture_filter_mode="auto_mip")))


def attr_phase(pt, gc, zc, rk, dev, card, early) -> dict:
    """Workload 1 textured with bench.py:587's 512² checker, 6 views at 512²
    through ``render``: the fused branch with tangents (K2), the classic
    branch (backend pallas: K4, then interpolate of t_tex_idx) with
    antialias_attr, and auto_mip; each against the port's CPU run of view
    0 (mask within 1e-4 of the foreground, attr 1e-4, pos 1e-4,
    normal and tangent 5e-4; the CPU's runs are attr_cpu_ref's, in the
    early CpuReferences). Returns the launches per kernel."""
    mesh, cam = sphere_scene(pt, dev, texture=checker(512, 32))
    refs = early.result("attr")
    launches = {}
    for name, kernel, kw in attr_variants(pt):
        def run(kw=kw):
            return pt.render(mesh, cam, 512, 512, device=dev, **kw)
        since = reset_counts()
        out = run()
        counts = read_counts(since)
        if counts[kernel] < 1:
            raise AssertionError(f"[attr] {name} did not launch {kernel}")
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
        ref = refs[name]
        fg = int(ref.mask.sum())
        mask = out.mask[CPU_VIEWS].cpu()
        mask_diff = int((mask != ref.mask).sum())
        both = mask & ref.mask
        fields = [("attr", 1e-4), ("pos", 1e-4), ("normal", 5e-4)]
        if out.tangent is not None:
            fields.append(("tangent", 5e-4))
        errs = {f: float((getattr(out, f)[CPU_VIEWS].cpu() - getattr(ref, f))[both]
                         .abs().max()) for f, _ in fields}
        ms = cuda_ms(run, 10)
        log("attr", f"{name}: launches {counts}; vs the port on the CPU (view "
            f"0): mask diff {mask_diff} of {fg}, {errs}; {ms:.4f} ms = "
            f"{len(cam) / (ms / 1e3):.2f} views/s ({card})")
        if not (mask_diff <= 1e-4 * fg and fg > 200_000
                and all(errs[f] < tol for f, tol in fields)):
            raise AssertionError(f"[attr] {name}: the card disagrees with the CPU")
    return launches


def chunk_phase(pt, gc, zc, rk, dev, card) -> int:
    """bench.py:614's config2: uv_sphere_mesh(65, 129), 32 views at 512²,
    depth and normals, auto_fast_config budgets; view_chunk=8 against the
    unchunked render on the card (mask equal, the rest within 1e-5), views/s
    both ways. Returns K1's launches."""
    verts, faces, uv = pt.uv_sphere_mesh(65, 129)
    mesh = pt.with_normals(pt.mesh_from_arrays(verts, faces, v_tex=uv,
                                               t_tex_idx=faces, device=dev))
    cam = pt.get_camera(elevation_deg=15.0, distance=2.7, fovy_deg=40.0,
                        num_views=32, near=0.1, far=10.0, device=dev)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    cfg = pt.auto_fast_config(pos, mesh.t_pos_idx, (512, 512), base=pt.FAST_TPU_CONFIG)
    kw = dict(render_attr=False, render_depth=True, render_normal=True,
              raster_config=cfg, device=dev)
    since = reset_counts()
    chunked = pt.render(mesh, cam, 512, 512, view_chunk=8, **kw)
    k1 = read_counts(since)["gbuffer_tiles"]
    if k1 < 1:
        raise AssertionError("config2 with view_chunk did not launch K1")
    whole = pt.render(mesh, cam, 512, 512, **kw)
    mask_diff = int((chunked.mask != whole.mask).sum())
    errs = {f: float((getattr(chunked, f) - getattr(whole, f)).abs().max())
            for f in ("pos", "depth", "normal")}
    ms_c = cuda_ms(lambda: pt.render(mesh, cam, 512, 512, view_chunk=8, **kw), 3)
    ms_w = cuda_ms(lambda: pt.render(mesh, cam, 512, 512, **kw), 3)
    log("chunk", f"config2 (32 views at 512²) view_chunk=8: K1 launches {k1}, "
        f"vs unchunked mask diff {mask_diff}, {errs}; chunked {ms_c:.4f} ms = "
        f"{32 / (ms_c / 1e3):.2f} views/s, unchunked {ms_w:.4f} ms = "
        f"{32 / (ms_w / 1e3):.2f} views/s ({card})")
    if mask_diff or max(errs.values()) > 1e-5:
        raise AssertionError("config2 chunked differs from unchunked")
    return k1


def ssaa_phase(pt, gc, zc, rk, dev, card) -> int:
    """The headline (bench.py:434) at ssaa=2 (1024² inside, budgets sized
    for it): the float coverage against the port's CPU run of views 0 and 3
    (summed difference within 1e-4 of the coverage, pos 1e-4 and normals
    5e-4 where both cover fully). Returns K1's launches."""
    mesh, cam = headline_scene(pt, dev)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    cfg = pt.auto_fast_config(pos, mesh.t_pos_idx, (1024, 1024))
    kw = dict(render_attr=False, render_depth=False, render_normal=True,
              raster_config=cfg, ssaa=2)
    since = reset_counts()
    out = pt.render(mesh, cam, 512, 512, device=dev, **kw)
    k1 = read_counts(since)["gbuffer_tiles"]
    if k1 < 1:
        raise AssertionError("the ssaa render did not launch K1")
    ref = pt.render(mesh.to("cpu"), cam[[0, 3]].to("cpu"), 512, 512, device="cpu",
                    **kw)
    cov = out.mask[[0, 3]].cpu()
    cover = float(ref.mask.sum())
    cov_diff = float((cov - ref.mask).abs().sum())
    full = (cov == 1.0) & (ref.mask == 1.0)
    errs = {f: float((getattr(out, f)[[0, 3]].cpu() - getattr(ref, f))[full]
                     .abs().max()) for f in ("pos", "normal")}
    ms = cuda_ms(lambda: pt.render(mesh, cam, 512, 512, device=dev, **kw), 5)
    log("ssaa", f"headline at ssaa=2: K1 launches {k1}; vs the port on the CPU "
        f"(views 0, 3): coverage diff {cov_diff} of {cover}, {errs}; "
        f"{ms:.4f} ms = {len(cam) / (ms / 1e3):.2f} views/s ({card})")
    if not (out.mask.dtype == torch.float32 and cov_diff <= 1e-4 * cover
            and errs["pos"] < 1e-4 and errs["normal"] < 5e-4):
        raise AssertionError("the ssaa render on the card disagrees with the CPU")
    return k1


# ---- Slice 7: real scenes and million-triangle meshes ------------------------

DATA = Path(__file__).resolve().parent / "tests" / "data"


def card_vs_cpu(out, ref, views, fields) -> tuple:
    """A render on the card against the port's CPU render of ``views``:
    (mask flips, foreground, {field: max abs error where both cover})."""
    mask = out.mask[views].cpu()
    both = mask & ref.mask
    errs = {f: float((getattr(out, f)[views].cpu() - getattr(ref, f))[both]
                     .abs().max()) for f in fields}
    return int((mask != ref.mask).sum()), int(ref.mask.sum()), errs


def log_profile(phase, what, fn, reps: int = 3, warm: bool = True,
                host_ops: bool = True) -> float:
    """A trace of ``reps`` calls of ``fn`` (profile_ms): wall ms, device-busy
    ms, idle share and CUDA kernels per call, and the top kernels. Returns
    the traced wall ms per call."""
    t0 = time.perf_counter()
    wall, busy, n_kernels, top = profile_ms(fn, reps, warm, host_ops)
    what = f"{what} ({time.perf_counter() - t0:.1f} s with the trace's own work)"
    if not n_kernels:
        log(phase, f"{what}: device time not measured (no CUDA kernels in "
            "the trace)")
        return wall
    log(phase, f"{what}: traced {wall:.3f} ms wall, device busy {busy:.3f} ms "
        f"({100 * (1 - busy / wall):.1f}% idle), {n_kernels:.0f} CUDA kernels "
        f"per call; top: " + "; ".join(
            f"{name} {ms:.4f} ms x{count:.0f}" for name, ms, count in top[:3]))
    return wall


def k1_logged_check(phase, what, gc, inputs, dims) -> None:
    """K1 against its plain version, bit for bit, on ``inputs``, with a
    line that gives their tiles and live chunks."""
    err = k1_against_plain(gc, inputs, dims)
    n_vals, tile_h, tile_w, n_ty, n_tx = dims[:5]
    log(phase, f"{what}: K1 on the render's inputs ({inputs[0].shape[0]} "
        f"views of {n_ty}x{n_tx} tiles of {tile_h}x{tile_w}, {n_vals} value "
        f"planes, {int(inputs[3].sum())} live chunks) bitwise equal to the "
        f"plain version (max abs err {err})")


def k1_path_check(phase, what, gb, gc, *args, **kw) -> None:
    """K1 against its plain version, bit for bit, on the inputs that a main
    path's render gives it (``gb._k1_inputs(*args, **kw)`` from the phase's
    own positions, triangles, attributes and config on the card)."""
    inputs, dims, _ = gb._k1_inputs(*args, **kw)
    k1_logged_check(phase, what, gc, inputs, dims)


@contextlib.contextmanager
def k1_inputs_kept(gb, kept: dict):
    """Within the block, each K1 launch through the port's one call site
    (ops/gbuffer.py's ``gbuffer_tiles``) also keeps its inputs in ``kept``,
    the first of each shape (K1's dims and the inputs' shapes): what a
    main path really hands K1, for k1_kept_check. Keeping them moves no
    data and launches nothing."""
    real = gb.gbuffer_tiles

    def keep(*args):
        inputs, dims = args[:4], args[4:]
        kept.setdefault((dims, tuple(tuple(t.shape) for t in inputs)),
                        (inputs, dims))
        return real(*args)

    with mock.patch.object(gb, "gbuffer_tiles", keep):
        yield


def k1_kept_check(phase, gc, kept: dict) -> None:
    """K1 against its plain version, bit for bit, on every input shape
    k1_inputs_kept kept (launches outside the main path's counts)."""
    if not kept:
        raise AssertionError(f"{phase}: no K1 inputs were kept")
    for i, (inputs, dims) in enumerate(kept.values()):
        k1_logged_check(phase, f"K1 input shape {i + 1} of {len(kept)}", gc,
                        inputs, dims)


def town_phase(pt, gb, gc, zc, rk, dev, card) -> dict:
    """bench.py:371-420 bench_town: the committed town (tests/data/town.glb,
    its camera path) loaded onto the card, 8 frames of the path at 384x576
    with colour (the strip atlas, attr_background 0.7), depth and normals,
    auto_fast_config over the fast config with backface_cull -1 (K1). The
    load's seconds, the budgets, views/s and K1's launches per render, the
    card against the port's CPU render of frames 0 and 4, the cull property of
    tests/test_town_fixture.py:86-125 on the card, and K1 on the render's
    inputs (576 = 4.5 tiles of 128: partial tiles) against its plain
    version. Returns the launches per kernel."""
    from worldrenderer_tpu_torch.render import _unify_cached
    from worldrenderer_tpu_torch.scene import load_camera_from_json

    h, w = 384, 576
    t0 = time.perf_counter()
    mesh = pt.load_mesh(str(DATA / "town.glb"), flip_uv=True, device=dev)
    cam, near, far = load_camera_from_json(DATA / "town_camera_path.json",
                                           h, w, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cam = cam[::100 // 8][:8]
    log("town", f"load_mesh + load_camera_from_json onto the card "
        f"{load_s:.3f} s: {mesh.num_faces} triangles, atlas "
        f"{tuple(mesh.texture.shape)}, registered as k/255 "
        f"{pt.is_registered_quantized_texture(mesh.texture)}, {len(cam)} "
        f"frames, the path's median near / far {near} / {far}")
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    cfg = pt.auto_fast_config(pos, mesh.t_pos_idx, (h, w),
                              base=pt.FAST_TPU_CONFIG._replace(backface_cull=-1))
    stats = pt.binning_stats(pos, mesh.t_pos_idx, (h, w), cfg)
    if not stats["ok"]:
        raise AssertionError(f"town: binning budgets lossy: {stats}")
    kw = dict(render_attr=True, render_depth=True, render_normal=True,
              attr_background=0.7, raster_config=cfg)

    def run():
        return pt.render(mesh, cam, h, w, device=dev, **kw)

    since = reset_counts()
    out = run()
    launches = read_counts(since)["gbuffer_tiles"]
    if launches < 1:
        raise AssertionError("town: render() did not launch K1")
    ms = cuda_ms(run, 20)
    log("town", f"budgets ok (live {stats['live_entries']}, max per tile "
        f"{stats['max_per_tile']} of {stats['k_cap']}); render {ms:.4f} ms = "
        f"{len(cam) / (ms / 1e3):.2f} views/s ({card}), K1 launches per render "
        f"{launches}")
    log_profile("town", "render", run)
    # The render's own seam cut and normals, as render() builds them.
    um = mesh
    if mesh.v_tex.shape[0] != mesh.v_pos.shape[0]:
        um = _unify_cached(mesh)
    um = pt.with_normals(um)
    v_nrm = um.v_nrm
    if v_nrm.shape[0] != um.v_pos.shape[0]:
        v_nrm = pt.compute_vertex_normals(um.v_pos, um.t_pos_idx)
    k1_path_check("town", "8 frames", gb, gc,
                  pt.get_clip_space_position(um.v_pos, cam.mvp_mtx),
                  um.t_pos_idx, torch.cat([v_nrm, um.v_tex], -1), h, w, cfg,
                  pos_world=um.v_pos, mvp=cam.mvp_mtx)

    views = TOWN_CPU_FRAMES
    ref = pt.render(mesh.to("cpu"), cam[views].to("cpu"), h, w, device="cpu",
                    **kw)
    mask_diff, fg, errs = card_vs_cpu(out, ref, views,
                                      ("attr", "pos", "depth", "normal"))
    g_gpu = pt.rasterize_gbuffer(pos[views], mesh.t_pos_idx, None, (h, w), cfg,
                                 device=dev)
    g_cpu = pt.rasterize_gbuffer(pos[views].cpu(), mesh.t_pos_idx.cpu(), None,
                                 (h, w), cfg, device="cpu")
    id_diff = int((g_gpu.tri_id.cpu() != g_cpu.tri_id).sum())
    both = out.mask[views].cpu() & ref.mask
    pos_bits = int((out.pos[views].cpu() != ref.pos)[both].any(-1).sum())
    extent = float(ref.pos[ref.mask].abs().max())
    log("town", f"vs the port on the CPU (frames {views}): mask diff {mask_diff}, "
        f"tri_id diff {id_diff} of {fg} foreground, max errors {errs}; "
        f"positions differ at {pos_bits} of {int(both.sum())} pixels both "
        f"cover (world extent {extent:.3f})")
    if not (mask_diff <= 1e-4 * fg and id_diff <= 1e-4 * fg
            and errs["attr"] < 1e-4 and errs["pos"] < 1e-4
            and errs["depth"] < 1e-4 and errs["normal"] < 5e-4
            and fg > 0.15 * len(views) * h * w):
        raise AssertionError("town: the card disagrees with the CPU")

    outs = {}
    for bf in (0, -1):
        c = pt.auto_fast_config(pos, mesh.t_pos_idx, (h, w), backface_cull=bf)
        outs[bf] = pt.rasterize_gbuffer(pos, mesh.t_pos_idx, None, (h, w), c,
                                        device=dev)
    a, b = outs[0], outs[-1]
    both = a.mask & b.mask
    cull = {"mask_diff": int((a.mask != b.mask).sum()),
            "id_flips": int(((a.tri_id != b.tri_id) & both).sum()),
            "foreground": int(both.sum())}
    same = both & (a.tri_id == b.tri_id)
    cull["z_max_diff"] = float((a.z - b.z).abs()[same].max())
    log("town", f"backface_cull 0 vs -1 on the card: {cull}")
    if (cull["mask_diff"] or cull["id_flips"] > max(16, cull["foreground"] // 2000)
            or cull["z_max_diff"] >= 1e-5):
        raise AssertionError(f"town: the cull property fails: {cull}")
    return {"gbuffer_tiles": launches}


def stress1m_scene(pt, dev, closed=False):
    """bench.py:298-354: the 999,698-triangle heightfield in the headline's
    orbit, or the closed 998,284-triangle UV sphere in workload 1's, 6
    views, with normals."""
    if closed:
        verts, faces, _ = pt.uv_sphere_mesh(707, 708)
        cam_kw = dict(elevation_deg=20.0, distance=2.7, fovy_deg=40.0)
    else:
        verts, faces = pt.make_grid_mesh(
            708, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y))
        cam_kw = dict(elevation_deg=35.0, distance=3.0, fovy_deg=50.0)
    mesh = pt.with_normals(pt.mesh_from_arrays(verts, faces, device=dev))
    cam = pt.get_camera(num_views=6, near=0.1, far=10.0, device=dev, **cam_kw)
    return mesh, cam


def mixed_tiny_scene(dev, n_big=200, n_tiny=30000, half=0.003, seed=0):
    """A scene of the class of tests/test_rasterize.py:778: big triangles,
    then sub-pixel ones (at 256², bbox under 0.8 px), each with its own
    vertices and random depths; random attributes (V, 5)."""
    rng = np.random.default_rng(seed)

    def tris(n, hw):
        centre = rng.uniform(-0.95, 0.95, (n, 2))
        xy = centre[:, None, :] + rng.uniform(-hw, hw, (n, 3, 2))
        return np.concatenate(
            [xy, rng.uniform(0.2, 0.9, (n, 3, 1)), np.ones((n, 3, 1))], -1)

    v = np.concatenate([tris(n_big, 0.3), tris(n_tiny, half)])
    v = torch.tensor(v.reshape(1, -1, 4), dtype=torch.float32, device=dev)
    tri = torch.arange(v.shape[1], device=dev).reshape(-1, 3)
    attr = torch.tensor(rng.normal(size=(v.shape[1], 5)), dtype=torch.float32,
                        device=dev)
    return v, tri, attr


def same_gbuffer_bits(a, b) -> bool:
    return all(same_bits(getattr(a, f), getattr(b, f))
               for f in ("mask", "tri_id", "z", "attr")
               if getattr(a, f) is not None)


def tiny_phase(pt, gb, pr, gc, zc, rk, dev, card) -> dict:
    """bench.py:298-367: both raw 1M-triangle scenes (the heightfield; the
    closed sphere with backface_cull -1), 6 views at 512², normals, the
    fast config with bin_tiny_px 1.0 through auto_fast_config. For each:
    the config, the budgets, the candidates against bin_tiny_cap, views/s
    and K1's launches, the sort path's time alone, view 0 against the
    port's CPU render, and the candidate cap on against off bit for bit.
    Then the sort path against none, bit for bit, on a scene where both fit
    (a mixed scene of 30,200 triangles at 256²), and vpu_pallas and
    fused_xla on the heightfield with the path on (K3 and K2 once each, K1
    never, each bitwise against its plain version). K1 on each scene's
    render inputs against its plain version. Returns the launches."""
    launches = {"gbuffer_tiles": 0, "zattr_tiles": 0, "zattr_tiles_vpu": 0}
    kw = dict(render_attr=False, render_depth=False, render_normal=True)
    hf = None
    for name, closed in (("heightfield", False), ("sphere", True)):
        mesh, cam = stress1m_scene(pt, dev, closed)
        tri = mesh.t_pos_idx
        pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
        base = pt.FAST_TPU_CONFIG._replace(bin_tiny_px=1.0,
                                           backface_cull=-1 if closed else 0)
        cfg = pt.auto_fast_config(pos, tri, (512, 512), base=base)
        stats = pt.binning_stats(pos, tri, (512, 512), cfg)
        if not stats["ok"]:
            raise AssertionError(f"{name}: binning budgets lossy: {stats}")
        log("tiny", f"{name} ({mesh.num_faces} triangles): auto_fast_config "
            f"max_tris_per_tile {cfg.max_tris_per_tile}, bin_huge "
            f"{cfg.bin_huge}, bin_med {cfg.bin_med}, bin_flat_cap_abs "
            f"{cfg.bin_flat_cap_abs}, bin_small_cap {cfg.bin_small_cap}, "
            f"bin_tiny_cap {cfg.bin_tiny_cap}, backface_cull "
            f"{cfg.backface_cull}; candidates (bbox under 1 px) "
            f"{stats['n_tiny_1px']}, covered {stats['n_tiny_cov']} of the cap "
            f"{stats['tiny_cap_budget']}; binned entries "
            f"{stats['live_entries']} of {stats['flat_cap']}, small tier "
            f"{stats['n_small_tris']} of {stats['small_cap_budget']}")

        def run(mesh=mesh, cam=cam, cfg=cfg):
            return pt.render(mesh, cam, 512, 512, raster_config=cfg,
                             device=dev, **kw)

        since = reset_counts()
        out = run()
        n = read_counts(since)["gbuffer_tiles"]
        if n < 1:
            raise AssertionError(f"{name}: render() did not launch K1")
        launches["gbuffer_tiles"] += n
        ms = cuda_ms(run, 20)
        setup = pr._triangle_setup_t(pr._clip_corners(pos, tri), 512, 512,
                                     cfg.backface_cull)
        sort_ms = cuda_ms(lambda: gb._tiny_for(setup, None, 512, 512, cfg), 20)
        log("tiny", f"{name}: render {ms:.4f} ms = {len(cam) / (ms / 1e3):.2f} "
            f"views/s ({card}), K1 launches per render {n}; the sort path "
            f"alone {sort_ms:.4f} ms ({100 * sort_ms / ms:.1f}% of the render)")
        log_profile("tiny", f"{name} render", run)
        k1_path_check("tiny", name, gb, gc, pos, tri, mesh.v_nrm, 512, 512, cfg,
                      pos_world=mesh.v_pos, mvp=cam.mvp_mtx)

        ref = pt.render(mesh.to("cpu"), cam[0].to("cpu"), 512, 512,
                        raster_config=cfg, device="cpu", **kw)
        mask_diff, fg, errs = card_vs_cpu(out, ref, [0], ("pos", "normal"))
        g_gpu = pt.rasterize_gbuffer(pos, tri, None, (512, 512), cfg, device=dev)
        g_cpu = pt.rasterize_gbuffer(pos[:1].cpu(), tri.cpu(), None, (512, 512),
                                     cfg, device="cpu")
        id_diff = int((g_gpu.tri_id[:1].cpu() != g_cpu.tri_id).sum())
        uncapped = pt.rasterize_gbuffer(pos, tri, None, (512, 512),
                                        cfg._replace(bin_tiny_cap=0), device=dev)
        cap_same = same_gbuffer_bits(g_gpu, uncapped)
        log("tiny", f"{name}: view 0 vs the port on the CPU: mask diff "
            f"{mask_diff}, tri_id diff {id_diff} of {fg} foreground, max "
            f"errors {errs}; bin_tiny_cap on vs off bitwise equal {cap_same}")
        if not (mask_diff <= 1e-4 * fg and id_diff <= 1e-4 * fg
                and errs["pos"] < 1e-4 and errs["normal"] < 5e-4
                and fg > 50_000 and cap_same):
            raise AssertionError(f"{name}: the card disagrees with the CPU or "
                                 "the capped sort path with the uncapped one")
        if not closed:
            hf = (pos, tri, mesh.v_nrm, cfg)
        del mesh, cam, out, ref, g_gpu, g_cpu, uncapped, setup

    v, tri, attr = mixed_tiny_scene(dev)
    exact = pt.RasterizerConfig(backend="fused_pallas")
    since = reset_counts()
    off = pt.rasterize_gbuffer(v, tri, attr, (256, 256), exact, device=dev)
    on_cfg = exact._replace(bin_tiny_px=1.0)
    st = pt.binning_stats(v, tri, (256, 256), on_cfg)
    on = pt.rasterize_gbuffer(v, tri, attr, (256, 256), on_cfg, device=dev)
    launches["gbuffer_tiles"] += read_counts(since)["gbuffer_tiles"]
    equal = same_gbuffer_bits(on, off)
    log("tiny", f"mixed scene ({tri.shape[0]} triangles, 256², 5 attributes): "
        f"the sort path ({st['n_tiny_1px']} candidates, {st['n_tiny_cov']} "
        f"covered) against none, bitwise equal {equal}; foreground "
        f"{int(on.mask.sum())}")
    if not (equal and st["ok"] and st["n_tiny_cov"] > 1000):
        raise AssertionError("the sort path changes bits against none")

    pos, tri, nrm, cfg = hf
    for backend, kernel in (("vpu_pallas", "zattr_tiles_vpu"),
                            ("fused_xla", "zattr_tiles")):
        bcfg = cfg._replace(backend=backend)

        def run(bcfg=bcfg):
            return pt.rasterize_gbuffer(pos, tri, nrm, (512, 512), bcfg,
                                        device=dev)

        since = reset_counts()
        run()
        counts = read_counts(since)
        if counts[kernel] != 1 or counts["gbuffer_tiles"]:
            raise AssertionError(f"heightfield with {backend}: {counts}")
        launches[kernel] += counts[kernel]
        inputs, dims, _ = gb._zattr_inputs(pos, tri, nrm, 512, 512, bcfg)
        err = bitwise_against_plain(
            kernel, getattr(zc, kernel)(*inputs, *dims),
            getattr(zc, f"{kernel}_plain")(*inputs, *dims))
        ms = cuda_ms(run, 5)
        log("tiny", f"heightfield with {backend}: launches {counts}; {kernel} "
            f"on the flat rows ({int(inputs[0].shape[0])} tiles, "
            f"{int(inputs[1].sum())} entries) bitwise equal to the plain "
            f"version (max abs err {err}); {ms:.4f} ms = "
            f"{len(pos) / (ms / 1e3):.2f} views/s ({card})")
        del inputs
    return launches


def digest(*arrays) -> str:
    """A short digest of host arrays' bytes."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:12]


def host_fma() -> str:
    """g++'s version, and whether its -march=native targets FMA on this host
    (and so contracts a*b + c in the mesh processor)."""
    macros = subprocess.run(["g++", "-march=native", "-dM", "-E", "-x", "c++",
                             "/dev/null"], capture_output=True, text=True,
                            check=True).stdout
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    return f"{gxx}, -march=native FMA {'on' if '__FMA__' in macros else 'off'}"


# Level 1 of the heightfield's chain (999,698 -> 62,481 faces) by the mesh
# processor built without contraction: the same on every x86-64 host (its
# decimation does IEEE adds, multiplies, divides and square roots only),
# for the input of this digest.
LOD_INPUT = "12435db617a5"
LOD_L1_NO_CONTRACT = (62481, "b1e6104dac7b")


def lod_phase(pt, gb, gc, zc, rk, dev, card) -> dict:
    """bench.py:867-891 bench_stress1m: build_lod_chain(factors=(1, 16, 64,
    256)) over the 999,698-triangle heightfield (host decimation by the
    port's meshproc), select(target_px_per_tri=2.0) for the 6 views at
    512², and the selected level's render through auto_fast_config (K1):
    the build's seconds, the faces per level, views/s, and the level's
    render against the port's CPU render (view 0), K1 on its inputs
    against its plain version. The chain is the host's: a digest of every
    level, level 1 against the port's library called again on the same
    input in this run (bit for bit), and level 1 from the library built
    without FMA contraction against its fixed result. Returns the launches
    per kernel."""
    from worldrenderer_tpu_torch import meshproc

    mesh, cam = stress1m_scene(pt, dev)
    t0 = time.perf_counter()
    chain = pt.build_lod_chain(mesh, factors=(1, 16, 64, 256), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    host = [a.cpu().numpy() for a in (mesh.v_pos, mesh.t_pos_idx)]
    v_in, f_in = host[0].astype(np.float64), host[1].astype(np.int64)
    levels = [digest(m.v_pos.cpu().numpy(), m.t_pos_idx.cpu().numpy())
              for m in chain.levels]
    target = len(f_in) // chain.factors[1]
    v1, f1 = meshproc.decimate(v_in, f_in, target)
    again = (np.array_equal(f1, chain.levels[1].t_pos_idx.cpu().numpy())
             and same_bits(torch.from_numpy(v1.astype(np.float32)),
                           chain.levels[1].v_pos.cpu()))
    v1n, f1n = meshproc.decimate(v_in, f_in, target,
                                 lib=meshproc._get_lib(meshproc.NO_CONTRACT))
    l1n = (len(f1n), digest(v1n, f1n))
    log("lod", f"{host_fma()}; input {digest(v_in, f_in)}; level "
        f"digests {levels}; level 1 by the library again on the same input "
        f"bitwise equal {again} ({len(f1)} faces, {digest(v1, f1)}); without "
        f"contraction {l1n[0]} faces, {l1n[1]} (fixed: {LOD_L1_NO_CONTRACT} "
        f"for input {LOD_INPUT})")
    if not again or (digest(v_in, f_in) == LOD_INPUT
                     and l1n != LOD_L1_NO_CONTRACT):
        raise AssertionError("lod: the mesh processor is not reproducible")
    level = chain.select(cam, 512, 512, target_px_per_tri=2.0)
    lod = pt.with_normals(chain.mesh_for(cam, 512, 512, device=dev,
                                         target_px_per_tri=2.0))
    pos = pt.get_clip_space_position(lod.v_pos, cam.mvp_mtx)
    cfg = pt.auto_fast_config(pos, lod.t_pos_idx, (512, 512))
    log("lod", f"build_lod_chain {build_s:.3f} s on the host: faces per level "
        f"{[int(m.num_faces) for m in chain.levels]} (factors "
        f"{chain.factors}); selected level {level}, {lod.num_faces} triangles, "
        f"bin_tiny_px {cfg.bin_tiny_px}, bin_med {cfg.bin_med}, bin_huge "
        f"{cfg.bin_huge}, max_tris_per_tile {cfg.max_tris_per_tile}")
    kw = dict(render_attr=False, render_depth=False, render_normal=True,
              raster_config=cfg)

    def run():
        return pt.render(lod, cam, 512, 512, device=dev, **kw)

    since = reset_counts()
    out = run()
    launches = read_counts(since)["gbuffer_tiles"]
    if launches < 1:
        raise AssertionError("lod: render() did not launch K1")
    ms = cuda_ms(run, 20)
    log_profile("lod", f"level {level} render", run)
    k1_path_check("lod", f"level {level}", gb, gc, pos, lod.t_pos_idx,
                  lod.v_nrm, 512, 512, cfg, pos_world=lod.v_pos,
                  mvp=cam.mvp_mtx)
    ref = pt.render(lod.to("cpu"), cam[CPU_VIEWS].to("cpu"), 512, 512,
                    device="cpu", **kw)
    mask_diff, fg, errs = card_vs_cpu(out, ref, CPU_VIEWS, ("pos", "normal"))
    log("lod", f"level {level}: render {ms:.4f} ms = "
        f"{len(cam) / (ms / 1e3):.2f} views/s ({card}), K1 launches per render "
        f"{launches}; vs the port on the CPU (view 0): mask diff "
        f"{mask_diff} of {fg}, max errors {errs}")
    if not (level > 0 and mask_diff <= 1e-4 * fg and errs["pos"] < 1e-4
            and errs["normal"] < 5e-4 and fg > 50_000):
        raise AssertionError("lod: the card disagrees with the CPU")
    return {"gbuffer_tiles": launches}


def subtile_phase(pt, gb, gc, zc, rk, dev, card) -> dict:
    """RasterizerConfig.bin_subtile, K1's row bands: the headline
    (bench.py:434, 6 views at 512²) and tests/test_gbuffer.py:297's scene
    (the 10,082-triangle grid, 2 views at 152x160: 152 rows need the padded
    band grid), each at sub 1, 2 and 4 through auto_fast_config at its band
    grid, normals as values. For each: K1 on the banded inputs bitwise equal
    to its plain version, the G-buffer (mask, tri_id, z, values) bitwise
    equal to sub 1's, and K1's ms beside the bound it reaches on the banded
    entry count. Returns the launches per kernel."""
    grid_v, grid_f = pt.make_grid_mesh(72)
    scenes = (
        ("headline", *headline_scene(pt, dev), (512, 512)),
        ("rows152", pt.mesh_from_arrays(grid_v, grid_f, device=dev),
         pt.get_camera(elevation_deg=35.0, distance=2.2, fovy_deg=50.0,
                       num_views=2, near=0.1, far=10.0, device=dev),
         (152, 160)),
    )
    launches = 0
    for name, mesh, cam, res in scenes:
        mesh = pt.with_normals(mesh)
        pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
        kw = dict(pos_world=mesh.v_pos, mvp=cam.mvp_mtx)
        ref = None
        for sub in (1, 2, 4):
            cfg = pt.auto_fast_config(
                pos, mesh.t_pos_idx, res,
                base=pt.FAST_TPU_CONFIG._replace(bin_subtile=sub))
            inputs, dims, _ = gb._k1_inputs(pos, mesh.t_pos_idx, mesh.v_nrm,
                                            *res, cfg, **kw)
            err = k1_against_plain(gc, inputs, dims)
            since = reset_counts()
            out = pt.rasterize_gbuffer(pos, mesh.t_pos_idx, mesh.v_nrm, res,
                                       cfg, device=dev, **kw)
            counts = read_counts(since)
            if counts["gbuffer_tiles"] != 1 or sum(counts.values()) != 1:
                raise AssertionError(f"subtile: launches {counts}")
            launches += 1
            ref = out if ref is None else ref
            equal = same_gbuffer_bits(out, ref)
            ms = cuda_ms(lambda: gc.gbuffer_tiles(*inputs, *dims), 50)
            bound, by, live = k1_bound_ms(inputs, dims)
            log("subtile", f"{name} sub {sub}: {dims[3] * sub}x{dims[4]} bins "
                f"of {dims[1] // sub}x{dims[2]}, {live} live chunks; K1 "
                f"bitwise equal to the plain version (max abs err {err}); "
                f"G-buffer bitwise equal to sub 1: {equal}; K1 {ms:.4f} ms, "
                f"bound {bound:.5f} ms by {by} ({100 * bound / ms:.0f}%) "
                f"({card})")
            if not equal:
                raise AssertionError(f"subtile: {name} at sub {sub} differs "
                                     "from sub 1")
    return {"gbuffer_tiles": launches}


BAKE_UV, BAKE_RES = 2048, 512
# Poisson sweeps the CPU runs for [bake_full]'s comparison.
BAKE_FULL_CPU_SWEEPS = 40


@functools.lru_cache(maxsize=None)
def bake_scene(pt, dev, texture_value=0.0):
    """bench.py:898 / :963's bake at full width: uv_sphere_mesh(65, 129)
    (16,384 triangles) with a flat 2048² texture, 6 views at 512² in
    workload 1's orbit, and the view images: renders of the same mesh with
    a seeded random texture, so the bake has texels to move. The config is
    sized for the atlas and the views as bench.py:941 _projection_auto_cfg
    sizes it. Made once per texture value: the phases only read it."""
    verts, faces, uv = pt.uv_sphere_mesh(65, 129)
    mesh = pt.mesh_from_arrays(
        verts, faces, v_tex=uv, t_tex_idx=faces,
        texture=np.full((BAKE_UV, BAKE_UV, 3), texture_value, np.float32),
        device=dev)
    cam = pt.get_camera(elevation_deg=20.0, distance=2.7, fovy_deg=40.0,
                        num_views=6, near=0.1, far=10.0, device=dev)
    seeded = torch.rand((BAKE_UV, BAKE_UV, 3),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    views = pt.render(mesh._replace(texture=seeded), cam, BAKE_RES, BAKE_RES,
                      device=dev).attr
    cfg = pt.auto_fast_config(
        atlas_clip(mesh), mesh.t_tex_idx, (BAKE_UV, BAKE_UV),
        extra_probes=[(pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx),
                       mesh.t_pos_idx, (BAKE_RES, BAKE_RES))])
    return mesh, cam, views, cfg


def bake_pieces(pu, mesh, cam, views, cfg, dev, **blend_kw):
    """bench.py's timed bake: uv_precompute, uv_render_geometry,
    uv_render_attr, uv_blend (keywords ``blend_kw``), each in a profiler
    range named after it. Returns the four stages' outputs."""
    from torch.profiler import record_function

    with record_function("bake::uv_precompute"):
        pre = pu.uv_precompute(mesh, BAKE_UV, BAKE_UV, raster_config=cfg,
                               device=dev)
    with record_function("bake::uv_render_geometry"):
        geo = pu.uv_render_geometry(mesh, cam, BAKE_RES, BAKE_RES, pre,
                                    raster_config=cfg, device=dev)
    with record_function("bake::uv_render_attr"):
        attr = pu.uv_render_attr(views, geo, device=dev)
    with record_function("bake::uv_blend"):
        out = pu.uv_blend(pre, geo, attr, device=dev, **blend_kw)
    return pre, geo, attr, out


def stage_split(fn) -> dict:
    """One torch.profiler trace of one call of ``fn``: by ``bake::`` range
    name, the device ms of the CUDA kernels that ran inside the spans of
    the ranges of that name on the device (one stream, so the stages'
    spans do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in events if not getattr(e, "is_user_annotation", False)]
    split = {}
    for span in events:
        if span.name.startswith("bake::") and span not in kernels:
            lo, hi = span.time_range.start, span.time_range.end
            name = span.name[len("bake::"):]
            split[name] = split.get(name, 0.0) + sum(
                k.time_range.elapsed_us() for k in kernels
                if lo <= k.time_range.start < hi) / 1e3
    return split


# TexturePipeline's rgb keywords, as the benchmark's tex4k cell bakes.
TEX4K_KW = dict(from_scratch=True, poisson_blending=False,
                depth_grad_dilation=5, depth_grad_threshold=None,
                uv_exp_blend_alpha=3, aoi_cos_valid_threshold=-1.0,
                pos_error_eps=1e-3, iou_rejection_threshold=None,
                uv_padding=True)


def sample_phase(pt, dev, card) -> dict:
    """[sample]: S1 against ``grid_sample_parts``'s plain version on the
    card, bit for bit, on :func:`synthetic_sample_inputs`, then on the two
    calls of a tex4k-shaped bake (``camera_projection`` with the tex4k
    keywords on [shard]'s scene: 6 views at 768², uv 4096): S1's time
    beside its byte bound (NDC read, output written and the maps read once
    over 3.35 TB/s), the plain version's and ``F.grid_sample``'s on the
    same call (NCHW, not the port's rounding). S1's launches per bake (2)
    and per textured render (0). Returns S1's kernels-line entry, its
    launches those of the calls checked here (read around each, the timing
    loops left out)."""
    from worldrenderer_tpu_torch.baking import projection as pp
    from worldrenderer_tpu_torch.baking import uv as pu
    from worldrenderer_tpu_torch.ops import grid_sample_cuda as gsc

    gs = importlib.import_module("worldrenderer_tpu_torch.ops.grid_sample")
    entry = {"name": "grid_sample_bilinear", "route": "cuda",
             "source": "worldrenderer_tpu_torch/csrc/grid_sample_bilinear.cu",
             "replaces": None, "launches": 0, "max_abs_err": 0.0, "ms": 0.0,
             "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
             "library_ms": 0.0}

    def against_plain(what, parts, grid, sample, want_launches):
        since = reset_counts()
        got = sample(parts, grid)
        n = read_counts(since)["grid_sample_bilinear"]
        want = gs.grid_sample_parts_plain(parts, grid)
        diff = bits_differ(got, want)
        # |got - want| where the bits differ (NaN if a NaN or inf differs)
        err = float(torch.where(got.view(torch.int32) == want.view(torch.int32),
                                0.0, (got - want).abs()).max())
        if diff or n != want_launches:
            raise AssertionError(f"S1 {what}: {diff} bits differ (max abs err "
                                 f"{err}), {n} launches")
        entry["launches"] += n
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        return got, n, diff

    for name, parts, grid in synthetic_sample_inputs(dev):
        got, n, diff = against_plain(name, parts, grid, gs.grid_sample_parts,
                                     -(-len(parts) // gsc.MAX_PARTS))
        log("sample", f"{name}: {len(parts)} parts, {got.shape[-1]} channels, "
            f"N {grid.shape[0]}: S1 launches {n}, bits differing from the "
            f"plain version {diff} (NaN {int(got.isnan().sum())}, -0 "
            f"{int(((got == 0) & got.signbit()).sum())})")

    mesh, cam, views, cfg = shard_scene(pt, dev)
    calls = []
    real = pu.grid_sample_parts

    def recording(parts, grid, device=None):
        calls.append((list(parts), grid))
        return real(parts, grid, device=device)

    since = reset_counts()
    # The geometry call comes from baking/uv.py, the images' through
    # grid_sample.
    with mock.patch.object(pu, "grid_sample_parts", recording), \
            mock.patch.object(gs, "grid_sample_parts", recording):
        pp.camera_projection(views, mesh, cam, uv_size=SHARD_UV,
                             raster_config=cfg, **TEX4K_KW)
    per_bake = read_counts(since)["grid_sample_bilinear"]
    c4, c4_cam = config4_scene(pt, dev)
    since = reset_counts()
    pt.render(c4, c4_cam, 1024, 1024, raster_config=config4_cfg(pt, c4, c4_cam),
              render_attr=True, device=dev)
    per_render = read_counts(since)["grid_sample_bilinear"]
    log("sample", f"S1 launches per tex4k-shaped bake {per_bake}, per "
        f"textured render {per_render}")
    if per_bake != len(calls) or per_bake != 2 or per_render:
        raise AssertionError("S1 is not on the bake's path alone")
    entry["launches"] += per_bake

    for what, (parts, grid) in zip(("geometry", "images"), calls):
        parts = [(torch.as_tensor(im, dtype=torch.float32, device=dev)
                  .contiguous(), pm) for im, pm in parts]
        grid = grid.contiguous()
        got = against_plain(f"on the bake's {what}", parts, grid,
                            gsc.sample_bilinear, 1)[0]
        s1_ms = cuda_ms(lambda: gsc.sample_bilinear(parts, grid), 20)
        plain_ms = cuda_ms(lambda: gs.grid_sample_parts_plain(parts, grid), 3)
        nchw = torch.cat([im for im, _ in parts], -1).permute(0, 3, 1, 2).contiguous()
        lib_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False), 20)
        nbytes = (grid.numel() * 4 + got.numel() * 4
                  + sum(im.numel() * (1 if pm == "u8" else 4) for im, pm in parts))
        bound_ms = nbytes / PEAK_BYTES * 1e3
        log("sample", f"bake {what}: maps {tuple(parts[0][0].shape[:3])} x "
            f"{[im.shape[-1] for im, _ in parts]} {[pm for _, pm in parts]}, "
            f"grid {tuple(grid.shape[:3])}: S1 bitwise equal to the plain "
            f"version; S1 {s1_ms:.4f} ms, bound {bound_ms:.4f} ms by bytes "
            f"({nbytes / 1e9:.3f} GB, {100 * bound_ms / s1_ms:.1f}%), plain "
            f"{plain_ms:.3f} ms, F.grid_sample {lib_ms:.4f} ms ({card})")
        for key, v in (("ms", s1_ms), ("plain_ms", plain_ms),
                       ("bound_ms", bound_ms), ("library_ms", lib_ms)):
            entry[key] += v
    return entry


def sample_readings() -> int:
    """``python3 chip_smoke.py --sample``: only the [sample] phase."""
    global cuda_ms, PEAK_BYTES
    import worldrenderer_tpu_torch as pt
    from worldrenderer_tpu_torch.ops import _build
    from worldrenderer_tpu_torch.probes import cuda_ms
    from worldrenderer_tpu_torch.utils.roofline import (
        H100_HBM_BYTES_PER_S as PEAK_BYTES,
    )

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = smi()
    log("env", card)
    t0 = time.perf_counter()
    logs = _build.build(["grid_sample_bilinear", "gbuffer_tiles",
                         "raster_zid_tiles"])
    log("build", f"built in {time.perf_counter() - t0:.2f} s")
    for line in logs["grid_sample_bilinear"].splitlines():
        if "registers" in line or "spill" in line:
            log("build", f"grid_sample_bilinear: {line.strip()}")
    entry = sample_phase(pt, torch.device("cuda"), card)
    print(json.dumps(entry))
    return 0


def bake_phase(pt, gb, gc, zc, rk, dev, card) -> dict:
    """bench.py:898 bench_projection on the port at full width
    (bake_scene): the timed pieces with uv_blend(do_uv_padding=False) —
    seconds per bake (CUDA events after warm-up), the stage split from one
    trace, CUDA kernels per bake and the device's idle share, K1's launches
    and its time at the 2048² atlas (bitwise against its plain version) —
    then camera_projection end to end with its defaults but
    poisson_blending=False on the card, its seconds. (Its comparison with
    the port's CPU run, with the same limits, is [warp]'s, on the same
    scene with the warp in front.) Returns the launches per kernel."""
    from worldrenderer_tpu_torch.baking import projection as pp
    from worldrenderer_tpu_torch.baking import uv as pu

    mesh, cam, views, cfg = bake_scene(pt, dev)

    def bake():
        return bake_pieces(pu, mesh, cam, views, cfg, dev, do_uv_padding=False)

    since = reset_counts()
    bake()
    counts = read_counts(since)
    # the atlas pass and the view renders, one K1 launch each; the
    # geometry and the images gathers, one S1 launch each
    if counts != only(gbuffer_tiles=2, grid_sample_bilinear=2):
        raise AssertionError(f"bake: launches {counts}")
    bake_ms = cuda_ms(bake, 5)
    split = stage_split(bake)
    log("bake", f"uv {BAKE_UV}², 6 views at {BAKE_RES}², {mesh.num_faces} "
        f"triangles: {bake_ms / 1e3:.4f} s per bake ({card}), K1 launches "
        f"{counts['gbuffer_tiles']}; stage split (device ms, one trace): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    log_profile("bake", "one bake", bake, reps=1)
    atlas_cfg = cfg._replace(backface_cull=0)
    inputs, dims, _ = gb._k1_inputs(atlas_clip(mesh), mesh.t_tex_idx,
                                    mesh.v_pos, BAKE_UV, BAKE_UV, atlas_cfg,
                                    tri_attr=mesh.t_pos_idx)
    err = k1_against_plain(gc, inputs, dims)
    atlas_ms = cuda_ms(lambda: gc.gbuffer_tiles(*inputs, *dims), 20)
    bound, by, live = k1_bound_ms(inputs, dims)
    log("bake", f"K1 at the {BAKE_UV}² atlas: {dims[3]}x{dims[4]} tiles, "
        f"{live} live chunks, bitwise equal to the plain version (max abs "
        f"err {err}); {atlas_ms:.4f} ms, bound {bound:.5f} ms by {by} "
        f"({100 * bound / atlas_ms:.0f}%)")

    kw = dict(uv_size=BAKE_UV, poisson_blending=False, raster_config=cfg)
    since = reset_counts()
    out = pp.camera_projection(views, mesh, cam=cam, device=dev, **kw)
    e2e = read_counts(since)
    launches = e2e["gbuffer_tiles"]
    e2e_ms = cuda_ms(lambda: pp.camera_projection(views, mesh, cam=cam,
                                                  device=dev, **kw), 3)
    baked = int(out.uv_proj_mask.sum())
    log("bake", f"camera_projection (poisson_blending=False): "
        f"{e2e_ms / 1e3:.4f} s on the card, launches {e2e}, "
        f"{baked} texels baked")
    if not (e2e == only(gbuffer_tiles=2, grid_sample_bilinear=2)
            and baked > 0.2 * BAKE_UV ** 2 and torch.isfinite(out.uv_proj).all()):
        raise AssertionError("bake: camera_projection on the card failed")
    return {name: counts[name] + e2e[name]
            for name in ("gbuffer_tiles", "grid_sample_bilinear")}


def bake_full_phase(pt, gb, gc, zc, rk, dev, card) -> dict:
    """bench.py:963 bench_projection_full on the port: the bake of
    bake_phase over a texture of 0.25 with 1,000 Jacobi sweeps of Poisson
    seam blending and gutter padding, seconds per bake; the Poisson loop's
    ms and CUDA kernels per sweep (the difference of 1,000 and 0 sweeps,
    and of two traces); then uv_blend_post on the card's own blend sums,
    on the card and on the CPU, at BAKE_FULL_CPU_SWEEPS sweeps: within
    1e-4 where the solve
    reaches (the blend mask dilated by the padding radius) and bitwise
    elsewhere. Returns the launches per kernel."""
    from worldrenderer_tpu_torch.baking import uv as pu
    from worldrenderer_tpu_torch.ops import image as im
    from worldrenderer_tpu_torch.ops import poisson as po

    mesh, cam, views, cfg = bake_scene(pt, dev, texture_value=0.25)
    full = dict(do_uv_padding=True, poisson_blending=True, pb_num_iters=1000)

    def bake():
        return bake_pieces(pu, mesh, cam, views, cfg, dev, **full)

    since = reset_counts()
    pre, geo, attr, out = bake()
    counts = read_counts(since)
    if counts != only(gbuffer_tiles=2, grid_sample_bilinear=2):
        raise AssertionError(f"bake_full: launches {counts}")
    if not torch.isfinite(out.uv_attr_blend).all():
        raise AssertionError("bake_full: the texture is not finite")
    bake_ms = cuda_ms(bake, 1)
    split = stage_split(bake)

    # The solve's own inputs, from the card's blend sums.
    sums = pu.uv_blend_sum(pre, geo, attr, device=dev)
    mask = sums.uv_valid_mask_blend
    src = pu.uv_padding(sums.uv_attr_blend, mask, 3, device=dev)

    def sweeps(n):
        return lambda: po.poisson_blend(src, mask, pre.uv_attr, num_iters=n,
                                        device=dev)

    sweep_ms = (cuda_ms(sweeps(1000), 2) - cuda_ms(sweeps(0), 5)) / 1000
    per_sweep = (profile_ms(sweeps(20), 1)[2] - profile_ms(sweeps(10), 1)[2]) / 10
    log("bake_full", f"1,000 Poisson sweeps and gutter padding: "
        f"{bake_ms / 1e3:.4f} s per bake ({card}), K1 launches "
        f"{counts['gbuffer_tiles']}; stage split (device ms, one trace): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; Poisson {sweep_ms:.4f} ms and {per_sweep:.1f} CUDA kernels per "
        f"sweep")

    post = dict(do_uv_padding=True, poisson_blending=True)
    cpu_pre = pre._replace(uv_attr=pre.uv_attr.cpu(), uv_mask=pre.uv_mask.cpu(),
                           uv_pos=pre.uv_pos.cpu())
    cpu_args = (cpu_pre, sums.uv_attr_blend.cpu(), mask.cpu())
    n = BAKE_FULL_CPU_SWEEPS
    t0 = time.perf_counter()
    ref = pu.uv_blend_post(*cpu_args, pb_num_iters=n, device="cpu", **post)
    cpu_s = time.perf_counter() - t0
    got = pu.uv_blend_post(pre, sums.uv_attr_blend, mask, pb_num_iters=n,
                           device=dev, **post).cpu()
    reach = im.batch_dilate(mask.cpu()[None], 7, device="cpu")[0]
    err = float((got - ref)[reach].abs().max())
    outside = bits_differ(got[~reach], ref[~reach])
    log("bake_full", f"uv_blend_post card vs CPU at {n} sweeps (the CPU "
        f"{cpu_s:.1f} s): max err {err} where the solve reaches, {outside} "
        f"texels with other bits elsewhere, {bits_differ(got, ref)} in all")
    if not (err <= 1e-4 and outside == 0 and torch.isfinite(got).all()):
        raise AssertionError("bake_full: the card disagrees with the CPU")
    return {name: counts[name] for name in ("gbuffer_tiles", "grid_sample_bilinear")}


def rel_err(got, want) -> float:
    """max |got - want| / max |want| of two tensors, on the host."""
    got, want = got.detach().cpu(), want.detach().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


DIFF_RES, FIT_RES = 512, 1024


def diff_scenes(pt, device):
    """[diff]'s rasterize_diff scenes: (name, mesh, cameras, uv, config,
    kernel) for workload 1 (DEFAULT_CONFIG: K4) and the headline with the
    grid's planar (x, y) as uv (auto_fast_config: K1 in uv mode)."""
    sph, scam = sphere_scene(pt, device)
    head, hcam = headline_scene(pt, device)
    hpos = pt.get_clip_space_position(head.v_pos, hcam.mvp_mtx)
    hcfg = pt.auto_fast_config(hpos, head.t_pos_idx, (DIFF_RES, DIFF_RES))
    hxy = head.v_pos[:, :2]
    huv = (hxy - hxy.min(0).values) / (hxy.max(0).values - hxy.min(0).values)
    return [("workload 1", sph, scam, sph.v_tex, pt.DEFAULT_CONFIG,
             "raster_zid_tiles"),
            ("headline", head, hcam, huv, hcfg, "gbuffer_tiles")]


def diff_loss(pt, p, tri, uv, cfg, device):
    """tests/test_differentiability.py:126's loss at DIFF_RES: the
    interpolated uv times a smooth field, through rasterize_diff."""
    ramp = torch.linspace(0, 1, DIFF_RES, device=device)[None, :, None, None]
    wfield = ramp * torch.linspace(1, 2, DIFF_RES, device=device)[None, None, :, None]
    rast = pt.rasterize_diff(p, tri, (DIFF_RES, DIFF_RES), cfg, device=device)
    return (pt.interpolate(uv[None], rast, tri, device=device) * wfield).sum() / 100.0


def fit_scene(pt, device, views=None):
    """[diff]'s texture fit: config4 (bench.py:684) with its config, the
    render keywords (colour, depth, normals: K1 at n_vals 6) and the target,
    half the config4 render of ``views`` (all when None)."""
    mesh, cam = config4_scene(pt, device)
    cfg = config4_cfg(pt, mesh, cam)
    cam = cam if views is None else cam[views]
    kw = dict(render_attr=True, render_depth=True, render_normal=True,
              raster_config=cfg, device=device)
    target = pt.render(mesh, cam, FIT_RES, FIT_RES, **kw).attr * 0.5
    return mesh, cam, cfg, kw, target


def fit_loss(pt, mesh, cam, target, tex, kw):
    out = pt.render(mesh, cam, FIT_RES, FIT_RES, texture_override=tex, **kw).attr
    return ((out - target) ** 2).mean()


def diff_cpu_ref(pt) -> dict:
    """[diff]'s CPU runs: view 0's clip-position gradient of each
    diff_scenes scene and view 0's texture gradient of the fit, with the
    configs they were sized to."""
    out = {}
    for name, mesh, cam, uv, cfg, _ in diff_scenes(pt, "cpu"):
        p = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)[:1]
        p.requires_grad_(True)
        t0 = time.perf_counter()
        diff_loss(pt, p, mesh.t_pos_idx, uv, cfg, "cpu").backward()
        out[name] = dict(grad=p.grad, cfg=cfg, seconds=time.perf_counter() - t0)
    mesh, cam, cfg, kw, target = fit_scene(pt, "cpu", CPU_VIEWS)
    tex = torch.full_like(mesh.texture, 0.5).requires_grad_(True)
    t0 = time.perf_counter()
    fit_loss(pt, mesh, cam, target, tex, kw).backward()
    out["config4"] = dict(grad=tex.grad, cfg=cfg, seconds=time.perf_counter() - t0)
    return out


def diff_phase(pt, gb, gc, zc, rk, dev, card, refs) -> dict:
    """Slice 10's gradients at full width. ``rasterize_diff`` on workload 1
    (3,968 triangles, 6 views at 512²: K4) and on the headline (10,082
    triangles under auto_fast_config, its budgets guarded as
    bench.py:452-459 guards them, doubled budgets giving the same rast: K1
    in uv mode), each with tests/test_differentiability.py:126's loss
    (diff_loss): the primal bitwise equal to ``rasterize`` on the card, the
    clip-position gradient of view 0 within 1e-4 of its largest |g| of the
    port's CPU gradient; then a texture-fit step on config4
    (bench.py:684, 4 views at 1024², K1 at n_vals 6), the texture gradient
    of view 0 within 1e-5 of its largest |g| of the CPU's. Each with the
    forward and forward + backward ms (CUDA events after warm-up) and CUDA
    kernels per step from one trace. The CPU runs are diff_cpu_ref's, in
    the early CpuReferences. Returns the launches per kernel."""
    launches = {"gbuffer_tiles": 0, "raster_zid_tiles": 0}
    scenes = diff_scenes(pt, dev)
    ref = refs.result("diff")
    for name, mesh, cam, uv, cfg, kernel in scenes:
        pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
        tri = mesh.t_pos_idx
        if kernel == "gbuffer_tiles":
            # bench.py:452-459's guard: doubled budgets give the same rast.
            cfg2 = cfg._replace(
                max_tris_per_tile=2 * cfg.max_tris_per_tile,
                bin_flat_cap_factor=2 * cfg.bin_flat_cap_factor,
                bin_huge=2 * cfg.bin_huge, bin_med=2 * cfg.bin_med)
            a, b = (pt.rasterize(pos, tri, (DIFF_RES, DIFF_RES), c, device=dev)
                    for c in (cfg, cfg2))
            if not (torch.equal(a[..., 3], b[..., 3])
                    and float((a[..., 2] - b[..., 2]).abs().max()) < 1e-6):
                raise AssertionError(f"diff {name}: the budgets truncate "
                                     "triangle lists")

        def loss(p, tri=tri, uv=uv, cfg=cfg):
            return diff_loss(pt, p, tri, uv, cfg, dev)

        p = pos.clone().requires_grad_(True)
        since = reset_counts()
        loss(p).backward()
        counts = read_counts(since)
        if counts[kernel] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"diff {name}: launches {counts}")
        launches[kernel] += counts[kernel]
        same = torch.equal(
            pt.rasterize_diff(p, tri, (DIFF_RES, DIFF_RES), cfg, device=dev).detach(),
            pt.rasterize(pos, tri, (DIFF_RES, DIFF_RES), cfg, device=dev))
        fwd_ms = cuda_ms(lambda: loss(p), 10)
        step_ms = cuda_ms(lambda: loss(p).backward(), 10)
        n_kernels = profile_ms(lambda: loss(p).backward(), 1)[2]
        p0 = pos[:1].clone().requires_grad_(True)
        loss(p0).backward()
        cpu = ref[name]
        err = rel_err(p0.grad, cpu["grad"])
        log("diff", f"rasterize_diff, {name} ({mesh.num_faces} triangles, 6 "
            f"views at {DIFF_RES}², {kernel} launches {counts[kernel]}): primal "
            f"bitwise equal to rasterize {same}; forward {fwd_ms:.4f} ms, "
            f"forward + backward {step_ms:.4f} ms, {n_kernels:.0f} CUDA "
            f"kernels per step ({card}); view 0's clip-position gradient vs "
            f"the CPU ({cpu['seconds']:.1f} s): max err {err:.3e} of its "
            f"largest |g|")
        if not (same and cfg == cpu["cfg"] and err <= 1e-4
                and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0):
            raise AssertionError(f"diff {name}: the card disagrees with the CPU")

    mesh, cam, cfg, kw, target = fit_scene(pt, dev)
    tex = torch.full_like(mesh.texture, 0.5).requires_grad_(True)
    since = reset_counts()
    fit_loss(pt, mesh, cam, target, tex, kw).backward()
    counts = read_counts(since)
    if counts["gbuffer_tiles"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"diff config4 fit: launches {counts}")
    launches["gbuffer_tiles"] += 1
    fwd_ms = cuda_ms(lambda: fit_loss(pt, mesh, cam, target, tex, kw), 3)
    step_ms = cuda_ms(lambda: fit_loss(pt, mesh, cam, target, tex, kw).backward(), 2)
    n_kernels = profile_ms(
        lambda: fit_loss(pt, mesh, cam, target, tex, kw).backward(), 1)[2]
    t0 = tex.detach().clone().requires_grad_(True)
    fit_loss(pt, mesh, cam[CPU_VIEWS], target[CPU_VIEWS], t0, kw).backward()
    cpu = ref["config4"]
    err = rel_err(t0.grad, cpu["grad"])
    log("diff", f"config4 texture-fit step (4 views at {FIT_RES}², K1 launches "
        f"{counts['gbuffer_tiles']}): forward {fwd_ms:.4f} ms, forward + "
        f"backward {step_ms:.4f} ms, {n_kernels:.0f} CUDA kernels per step "
        f"({card}); view 0's texture gradient vs the CPU "
        f"({cpu['seconds']:.1f} s): max err {err:.3e} of its largest |g|")
    if not (cfg == cpu["cfg"] and err <= 1e-5 and t0.grad.abs().sum() > 0
            and torch.isfinite(tex.grad).all()):
        raise AssertionError("diff config4: the card disagrees with the CPU")
    return launches


def smooth_texture(size):
    """A (size, size, 3) texture of a few sine periods per axis: smooth at
    the warp's 64² and 128² stages, so the fit's loss is smooth too (on the
    bake's per-texel noise the fit is chaotic, and round-off sends the
    card and the CPU to other optima)."""
    t = torch.linspace(0.0, 2.0 * np.pi, size)
    v, u = torch.meshgrid(t, t, indexing="ij")
    return torch.stack([0.5 + 0.4 * torch.sin(3 * u + 2 * v),
                        0.5 + 0.4 * torch.cos(2 * u - 3 * v),
                        0.5 + 0.4 * torch.sin(4 * u) * torch.cos(4 * v)], -1)


PAINT_SCORE, PAINT_INPAINT = 256, 1024
# The round held against the CPU: the sizes the CPU fits in time, on tiles
# of 8x32 (the plain K1 scans each tile's chunks over all its pixels, and
# the score views' triangles are about a pixel each).
PAINT_CPU_SCORE, PAINT_CPU_INPAINT = 128, 512
PAINT_CPU_TILES = dict(tile_h=8, tile_w=32)
PAINT_SEED = 5
CPU_REF_DIR = Path(__file__).resolve().parent / "_cpu_refs"


def headline_cfg(pt, mesh, cam, size=512):
    """The main path's config: auto_fast_config over the headline."""
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    return pt.auto_fast_config(pos, mesh.t_pos_idx, (size, size))


def main_cpu_ref(pt) -> dict:
    """[main]'s CPU run: the headline render (6 views) and its triangle
    ids, with the config they were sized to."""
    t0 = time.perf_counter()
    mesh, cam = headline_scene(pt, "cpu")
    cfg = headline_cfg(pt, mesh, cam)
    ref = pt.render(mesh, cam, 512, 512, render_attr=False, render_depth=False,
                    render_normal=True, raster_config=cfg, device="cpu")
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    ids = pt.rasterize_gbuffer(pos, mesh.t_pos_idx, None, (512, 512), cfg,
                               device="cpu").tri_id
    return dict(render=ref, tri_id=ids, cfg=cfg,
                seconds=time.perf_counter() - t0)


def flat_cpu_ref(pt) -> dict:
    """[flat]'s CPU runs: view 0 of the headline through rasterize_gbuffer
    with vpu_pallas and fused_xla."""
    mesh, cam = headline_scene(pt, "cpu")
    cfg = headline_cfg(pt, mesh, cam)
    mesh = pt.with_normals(mesh)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)[CPU_VIEWS]
    return {b: pt.rasterize_gbuffer(pos, mesh.t_pos_idx, mesh.v_nrm, (512, 512),
                                    cfg._replace(backend=b), device="cpu")
            for b in ("vpu_pallas", "fused_xla")}


def attr_cpu_ref(pt) -> dict:
    """[attr]'s CPU runs: view 0 of each of attr_variants."""
    mesh, cam = sphere_scene(pt, "cpu", texture=checker(512, 32))
    return {name: pt.render(mesh, cam[CPU_VIEWS], 512, 512, device="cpu", **kw)
            for name, _, kw in attr_variants(pt)}


def warp_cpu_ref(pt, src, tgt, mesh, cam, kw) -> dict:
    """[warp]'s CPU run: compute_warp_field, then camera_projection with
    ``kw`` (warp_images=True), its atlas kept."""
    from worldrenderer_tpu_torch.baking import projection as pp
    from worldrenderer_tpu_torch.baking import warp as pw

    t0 = time.perf_counter()
    warped = pw.compute_warp_field(src, tgt, device="cpu")
    fit_s = time.perf_counter() - t0
    pres = []
    real = pp.uv_precompute

    def keep_pre(*a, **k):
        pres.append(real(*a, **k))
        return pres[-1]

    t0 = time.perf_counter()
    with mock.patch.object(pp, "uv_precompute", keep_pre):
        out = pp.camera_projection(src, mesh, cam=cam, device="cpu", **kw)
    return dict(warped=warped, fit_s=fit_s, bake_s=time.perf_counter() - t0,
                uv_proj=out.uv_proj, uv_proj_mask=out.uv_proj_mask,
                uv_mask=pres[0].uv_mask, uv_pos=pres[0].uv_pos)


def paint_cpu_ref(pt, mesh, tex, hole, cfg, kw) -> dict:
    """[paint]'s CPU round."""
    from worldrenderer_tpu_torch.baking import smart_paint as ps

    painter = ps.SmartPainter(cfg)
    t0 = time.perf_counter()
    out, covered = painter(mesh, ps.default_inpaint_func, tex, hole,
                           device="cpu",
                           generator=torch.Generator().manual_seed(PAINT_SEED),
                           **kw)
    return dict(texture=out, covered=covered, seconds=time.perf_counter() - t0,
                best_view=painter.history[0]["best_view"])


CPU_REFS = {"main": main_cpu_ref, "flat": flat_cpu_ref, "attr": attr_cpu_ref,
            "diff": diff_cpu_ref, "warp": warp_cpu_ref, "paint": paint_cpu_ref}


def cpu_references(spec: str) -> int:
    """``python3 chip_smoke.py --cpu-refs TAG:main,flat``: the named CPU
    runs, in order, on the inputs in CPU_REF_DIR/TAG (none for the runs
    that build their scenes themselves), each written there when done."""
    import worldrenderer_tpu_torch as pt

    tag, names = spec.split(":")
    base = CPU_REF_DIR / tag
    for name in names.split(","):
        src = base / f"{name}.in.pt"
        args = torch.load(src, weights_only=False) if src.exists() else {}
        out = CPU_REFS[name](pt, **args)
        tmp = base / f"{name}.tmp.pt"
        torch.save(out, tmp)
        tmp.replace(base / f"{name}.out.pt")
    return 0


class CpuReferences:
    """CPU runs that phases hold the card against, in order, in a process
    of their own at the lowest priority (nice 19): it takes the cores that
    the card's host-bound phases (one launching thread) leave idle, and
    yields them whenever this process computes on the CPU. ``jobs`` maps
    a CPU_REFS name to its inputs (None: it builds its scene itself)."""

    def __init__(self, tag: str, jobs: dict):
        import shutil

        self.dir = CPU_REF_DIR / tag
        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True)
        for name, args in jobs.items():
            if args is not None:
                torch.save(args, self.dir / f"{name}.in.pt")
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cpu-refs",
             f"{tag}:{','.join(jobs)}"], preexec_fn=lambda: os.nice(19))

    def result(self, name: str) -> dict:
        out = self.dir / f"{name}.out.pt"
        while not out.exists():
            if self.proc.poll() is not None and not out.exists():
                raise AssertionError(f"the CPU run {name} failed (exit "
                                     f"{self.proc.returncode})")
            time.sleep(0.1)
        return torch.load(out, weights_only=False)

    def close(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)
        if CPU_REF_DIR.exists() and not any(CPU_REF_DIR.iterdir()):
            CPU_REF_DIR.rmdir()


class Slice10:
    """The [warp] and [paint] phases' inputs, made on the card once, and
    their CPU runs (CpuReferences), started with them.

    [warp]: bake_scene's mesh with a smooth texture (smooth_texture), its
    6 views at 512² as targets over a 0.5 background, and as sources the
    same renders from cameras jittered by perturb_camera_position=0.01 (a
    fixed generator), so the fit has a real offset to remove.

    [paint]: bake_scene's mesh at the application's scale (load_mesh's
    rescale to a half-extent of 0.5, which the anchor rig at distance 1.2
    expects), camera_projection's texture of bake_scene's views at 2048²,
    and as the inpaint mask the chart texels that no view covered (the
    poles and beyond); the config sized by auto_fast_config over the atlas,
    the anchor rig at 256² and at 1024² (any of its views may be a round's)
    and the bake's views, each probe checked against its budgets; the
    CPU-compared round's config the same on 8x32 tiles at its sizes."""

    def __init__(self, pt, dev):
        from worldrenderer_tpu_torch.baking import smart_paint as ps

        t0 = time.perf_counter()
        mesh, cam, views, cfg = bake_scene(pt, dev)
        wmesh = mesh._replace(texture=smooth_texture(BAKE_UV).to(dev))
        moved = pt.get_camera(c2w=cam.c2w.cpu(), fovy_deg=40.0, near=0.1,
                              far=10.0, perturb_camera_position=0.01,
                              generator=torch.Generator().manual_seed(1),
                              device=dev)
        kw = dict(render_depth=False, render_normal=False, attr_background=0.5,
                  raster_config=cfg, device=dev)
        self.warp = dict(
            mesh=wmesh, cam=cam, cfg=cfg,
            src=pt.render(wmesh, moved, BAKE_RES, BAKE_RES, **kw).attr,
            tgt=pt.render(wmesh, cam, BAKE_RES, BAKE_RES, **kw).attr,
            kw=dict(uv_size=BAKE_UV, poisson_blending=False, raster_config=cfg,
                    warp_images=True, images_background=0.5))

        pmesh = mesh._replace(v_pos=mesh.v_pos * 0.5)
        rig = ps._make_view_selection_cams(device=dev)
        rig_pos = pt.get_clip_space_position(pmesh.v_pos, rig.mvp_mtx)
        atlas = (atlas_clip(mesh), mesh.t_tex_idx, (BAKE_UV, BAKE_UV))
        view_probe = (pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx),
                      mesh.t_pos_idx, (BAKE_RES, BAKE_RES))

        def sized(base, score, inpaint):
            probes = [(rig_pos, mesh.t_pos_idx, (score, score)),
                      (rig_pos, mesh.t_pos_idx, (inpaint, inpaint)), view_probe]
            c = pt.auto_fast_config(*atlas, base=base, extra_probes=probes)
            for pos, tri, res in probes + [atlas]:
                chk = c._replace(backface_cull=0) if pos is atlas[0] else c
                stats = pt.binning_stats(pos, tri, res, chk)
                if not stats["ok"]:
                    raise AssertionError(f"paint: lossy budgets at {res}: {stats}")
            return c

        pcfg = sized(pt.FAST_TPU_CONFIG, PAINT_SCORE, PAINT_INPAINT)
        small_cfg = sized(pt.FAST_TPU_CONFIG._replace(**PAINT_CPU_TILES),
                          PAINT_CPU_SCORE, PAINT_CPU_INPAINT)
        proj = pt.baking.camera_projection(views, mesh, cam=cam, uv_size=BAKE_UV,
                                           poisson_blending=False,
                                           raster_config=pcfg, device=dev)
        chart = pt.baking.uv_precompute(mesh, BAKE_UV, BAKE_UV,
                                        raster_config=pcfg, device=dev).uv_mask
        self.paint = dict(
            mesh=pmesh._replace(texture=proj.uv_proj), tex=proj.uv_proj,
            hole=chart & ~proj.uv_proj_mask, chart=chart, cfg=pcfg,
            small_cfg=small_cfg,
            small_kw=dict(max_view_score_thresh=0.02, min_rounds=1,
                          max_rounds=1, uv_padding_end=True,
                          score_render_size=PAINT_CPU_SCORE,
                          inpaint_render_size=PAINT_CPU_INPAINT))
        self.setup_s = time.perf_counter() - t0
        w, p = self.warp, self.paint
        self.refs = CpuReferences("late", {
            "warp": dict(src=w["src"].cpu(), tgt=w["tgt"].cpu(),
                         mesh=w["mesh"].to("cpu"), cam=w["cam"].to("cpu"),
                         kw=w["kw"]),
            "paint": dict(mesh=p["mesh"].to("cpu"), tex=p["tex"].cpu(),
                          hole=p["hole"].cpu(), cfg=small_cfg,
                          kw=p["small_kw"]),
        })


def warp_phase(pt, gb, gc, zc, rk, dev, card, s10) -> dict:
    """Slice 10's warp fit on the bake's scene (Slice10.warp: bake_scene's
    16,384 triangles, 6 views at 512², uv 2048²): ``compute_warp_field``
    at its defaults, the card's warped images against the CPU's within
    1e-3, with the fit's seconds and CUDA kernels per Adam step; then
    ``camera_projection(warp_images=True, images_background=0.5)`` end to
    end, its seconds and K1's launches (the atlas, the view maps and the
    warp's target render), against the CPU's: the atlas's uv_mask equal
    and uv_pos within 1e-5, baked-mask flips at most 1e-4 of the chart's
    texels, texels within 1e-4 where both are valid. Returns the launches
    per kernel."""
    from worldrenderer_tpu_torch.baking import projection as pp
    from worldrenderer_tpu_torch.baking import warp as pw

    w = s10.warp
    src, tgt, mesh, cam, kw = w["src"], w["tgt"], w["mesh"], w["cam"], w["kw"]

    def fit():
        return pw.compute_warp_field(src, tgt, device=dev)

    warped = fit()
    fit_ms = cuda_ms(fit, 2)
    steps = 2 * 20
    per_step = (profile_ms(fit, 1)[2]
                - profile_ms(lambda: pw.compute_warp_field(
                    src, tgt, optim_step_per_res=0, device=dev), 1)[2]) / steps

    pres = []
    real = pp.uv_precompute

    def keep_pre(*a, **k):
        pres.append(real(*a, **k))
        return pres[-1]

    since = reset_counts()
    with mock.patch.object(pp, "uv_precompute", keep_pre):
        out = pp.camera_projection(src, mesh, cam=cam, device=dev, **kw)
    counts = read_counts(since)
    # the warp's target render, the atlas and the view maps; S1 on the two
    # gathers (the warp's fit samples under autograd: the plain version)
    if counts != only(gbuffer_tiles=3, grid_sample_bilinear=2):
        raise AssertionError(f"warp: camera_projection launches {counts}")
    bake_ms = cuda_ms(lambda: pp.camera_projection(src, mesh, cam=cam,
                                                   device=dev, **kw), 2)

    t0 = time.perf_counter()
    ref = s10.refs.result("warp")
    waited = time.perf_counter() - t0
    err = float((warped.cpu() - ref["warped"]).abs().max())
    before = float(((src - tgt) ** 2).mean())
    after = float(((warped - tgt) ** 2).mean())
    after_cpu = float(((ref["warped"] - tgt.cpu()) ** 2).mean())
    log("warp", f"compute_warp_field, 6 views at {BAKE_RES}² (n_grid 10, "
        f"optim_res (64, 128), 20 steps each): {fit_ms / 1e3:.4f} s per fit, "
        f"{per_step:.1f} CUDA kernels per Adam step ({card}); mean squared "
        f"error to the targets {before:.6f} -> {after:.6f} (CPU "
        f"{after_cpu:.6f}); card vs CPU ({ref['fit_s']:.1f} s): warped images "
        f"max err {err:.3e}")
    chart = ref["uv_mask"]
    mask_eq = torch.equal(pres[0].uv_mask.cpu(), chart)
    pos_err = float((pres[0].uv_pos.cpu() - ref["uv_pos"])[chart].abs().max())
    flips = int((out.uv_proj_mask.cpu() != ref["uv_proj_mask"]).sum())
    both = out.uv_proj_mask.cpu() & ref["uv_proj_mask"]
    tex_err = float((out.uv_proj.cpu() - ref["uv_proj"])[both].abs().max())
    log("warp", f"camera_projection(warp_images=True): {bake_ms / 1e3:.4f} s "
        f"per bake, K1 launches {counts['gbuffer_tiles']} ({card}); card vs "
        f"CPU ({ref['bake_s']:.1f} s in a process of its own, waited "
        f"{waited:.1f} s): uv_mask equal {mask_eq}, uv_pos max err {pos_err}, "
        f"baked-mask flips {flips} of {int(chart.sum())} chart texels "
        f"({int(ref['uv_proj_mask'].sum())} baked), texel max err "
        f"{tex_err:.3e} where both are valid")
    if not (err <= 1e-3 and after < before and torch.isfinite(warped).all()):
        raise AssertionError("warp: the card's fit disagrees with the CPU's")
    if not (mask_eq and pos_err <= 1e-5 and flips <= 1e-4 * int(chart.sum())
            and tex_err <= 1e-4 and both.float().mean() > 0.2
            and torch.isfinite(out.uv_proj).all()):
        raise AssertionError("warp: the card's bake disagrees with the CPU's")
    return {name: counts[name] for name in ("gbuffer_tiles", "grid_sample_bilinear")}


def paint_phase(pt, gb, gc, zc, rk, dev, card, s10) -> dict:
    """Slice 10's smart painter at the application's settings
    (texture_pipeline.py:203-214, ModProcessConfig :42-45): score renders
    108 x 256², inpaint renders 1024², min_rounds 4, max_rounds 8,
    threshold 0.02, default_inpaint_func, uv_padding_end on, over
    Slice10.paint. Prints the rounds and seconds per round, one round's
    stage split from a trace (the score render, the two 1024² renders, the
    inpaint, the projection), CUDA kernels per round and the device's idle
    share. Then one round (min_rounds = max_rounds = 1) on the card against
    the port's CPU run, both with the same rig (the same generator), at
    score 128² and inpaint 512² on 8x32 tiles (PAINT_CPU_*): the same best
    view, covered-mask flips at most 1e-4 of chart texels, texels within
    1e-4 where both are valid. Returns the launches per kernel."""
    from torch.profiler import record_function

    from worldrenderer_tpu_torch.baking import smart_paint as ps

    p = s10.paint
    mesh, tex, hole, chart = p["mesh"], p["tex"], p["hole"], p["chart"]
    painter = ps.SmartPainter(p["cfg"])
    kw = dict(max_view_score_thresh=0.02, min_rounds=4, max_rounds=8,
              uv_padding_end=True, score_render_size=PAINT_SCORE,
              inpaint_render_size=PAINT_INPAINT)
    since = reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, covered = painter(mesh, ps.default_inpaint_func, tex, hole, device=dev,
                           **kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts(since)
    rounds = len(painter.history)
    # a round: the score render, the two 1024² renders, the projection's
    # atlas and view maps (K1), the projection's two gathers (S1)
    if counts != only(gbuffer_tiles=5 * rounds, grid_sample_bilinear=2 * rounds):
        raise AssertionError(f"paint: launches {counts} in {rounds} rounds")
    scores = [float(h["view_scores"].max()) for h in painter.history]
    log("paint", f"SmartPainter over {int(hole.sum())} uncovered of "
        f"{int(chart.sum())} chart texels (set-up {s10.setup_s:.1f} s): "
        f"{rounds} rounds in {run_s:.3f} s ({run_s / rounds:.4f} s per round, "
        f"{card}), K1 launches {counts['gbuffer_tiles']}; best views "
        f"{[h['best_view'] for h in painter.history]}, worst scores "
        f"{[round(s, 5) for s in scores]}; {int((covered & hole).sum())} of "
        "the uncovered texels covered")
    if not (torch.isfinite(out).all() and bool((covered | hole).all())
            and int((covered & hole).sum()) > 0):
        raise AssertionError("paint: the painter did not cover new texels")

    # One round's stage split: each step of the round in a profiler range.
    def ranged(fn, label):
        def wrapped(*a, **k):
            with record_function("bake::" + label(a)):
                return fn(*a, **k)
        return wrapped

    one = dict(kw, min_rounds=1, max_rounds=1)
    render_label = ranged(ps.render, lambda a: "score render"
                          if a[2] == PAINT_SCORE else "1024² renders")

    def one_round():
        with mock.patch.object(ps, "render", render_label), \
                mock.patch.object(ps, "camera_projection",
                                  ranged(ps.camera_projection,
                                         lambda a: "projection")):
            return painter(mesh, ranged(ps.default_inpaint_func,
                                        lambda a: "inpaint"),
                           tex, hole, device=dev, **one)

    split = stage_split(one_round)
    wall, busy, n_kernels, _ = profile_ms(
        lambda: painter(mesh, ps.default_inpaint_func, tex, hole, device=dev,
                        **one), 1)
    log("paint", "one round's stage split (device ms, one trace): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; traced {wall:.1f} ms wall, device busy {busy:.1f} ms "
        f"({100 * (1 - busy / wall):.1f}% idle), {n_kernels:.0f} CUDA kernels "
        "per round")

    small = ps.SmartPainter(p["small_cfg"])
    got, got_cov = small(mesh, ps.default_inpaint_func, tex, hole, device=dev,
                         generator=torch.Generator().manual_seed(PAINT_SEED),
                         **p["small_kw"])
    got_view = small.history[0]["best_view"]
    t0 = time.perf_counter()
    ref = s10.refs.result("paint")
    waited = time.perf_counter() - t0
    chart_n = int(chart.sum())
    flips = int((got_cov.cpu() != ref["covered"]).sum())
    both = got_cov.cpu() & ref["covered"]
    tex_err = float((got.cpu() - ref["texture"])[both].abs().max())
    log("paint", f"one round at score {PAINT_CPU_SCORE}², inpaint "
        f"{PAINT_CPU_INPAINT}², 8x32 tiles, card vs CPU ({ref['seconds']:.1f} "
        f"s in a process of its own, waited {waited:.1f} s): best view "
        f"{got_view} / {ref['best_view']}, covered-mask flips {flips} of "
        f"{chart_n} chart texels, texel max err {tex_err:.3e} where both are "
        "valid")
    if not (got_view == ref["best_view"] and flips <= 1e-4 * chart_n
            and tex_err <= 1e-4):
        raise AssertionError("paint: the card's round disagrees with the CPU's")
    return {name: counts[name] for name in ("gbuffer_tiles", "grid_sample_bilinear")}

# ---- Slice 11: the application --------------------------------------------

# [app]: project_and_render at the CLI's defaults on the committed town:
# 24 frames of its camera path at bench.py:371's 384x576, uv 2048, the host
# atlas (uv_unwarp), raster "exact", pos_error_eps "auto". Its CPU
# comparison: the first 4 frames at 192x288, uv 512.
APP_FRAMES, APP_RES, APP_UV = 24, (384, 576), 2048
APP_CPU_FRAMES, APP_CPU_RES, APP_CPU_UV = 4, (192, 288), 512
# [texpipe]: TexturePipeline on the six-view ORTHO rig at 768², uv 4096; its
# CPU comparison at 128², uv 256.
TEXPIPE_RES, TEXPIPE_UV = 768, 4096
TEXPIPE_CPU_RES, TEXPIPE_CPU_UV = 128, 256


def texpipe_cpu_cfg(pt):
    """The CPU-compared call's config, on both sides: DEFAULT_CONFIG on tiles
    of 8x32, as [paint]'s CPU round (the plain K1 scans each tile's chunks
    over all its pixels; 5 s on the CPU against 25 s or more on 32x128)."""
    return pt.DEFAULT_CONFIG._replace(**PAINT_CPU_TILES)

# Where the two phases write (git-ignored; removed at the end).
APP_DIR = Path(__file__).resolve().parent / "_app_out"


def app_footage(pt, dev, n, res):
    """The town's own views from the first ``n`` cameras of its path
    (load_mesh(flip_uv=True), attr_background 0), quantized to k/255 as an
    8-bit video frame is written ((clip * 255) truncated): (n, H, W, 3)
    host float32, what ``load_frames`` returns for such a video."""
    from worldrenderer_tpu_torch.scene import load_camera_from_json

    mesh = pt.load_mesh(str(DATA / "town.glb"), flip_uv=True, device=dev)
    cam, _, _ = load_camera_from_json(DATA / "town_camera_path.json", *res,
                                      max_views=n, device=dev)
    attr = pt.render(mesh, cam, *res, render_depth=False, render_normal=False,
                     attr_background=0.0, device=dev).attr
    return (torch.floor(attr.clamp(0.0, 1.0) * 255.0) / 255.0).cpu().numpy()


def app_call(footage, work, res, uv, dev, announce=False):
    """``project_and_render`` as the CLI runs it (``--blend-path`` a copy of
    tests/data/town.glb in ``work``, whose host atlas is written beside
    it; ``--camera-json`` its path; ``--max-frames`` the footage's count;
    ``--pos-error-eps auto``; every other argument its default) into
    ``work/out``. The one name ``load_frames`` of the module is replaced,
    for this call only, by a function that returns ``footage``: the
    card's machine has no OpenCV to decode a video."""
    import shutil

    from worldrenderer_tpu_torch.pipelines import project_render as ppr

    n = len(footage)
    glb = work / "town.glb"
    if not glb.exists():
        work.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(DATA / "town.glb", glb)

    def load_frames(video_path, frame_offset, frame_step, max_frames):
        if (frame_offset, frame_step, max_frames) != (0, 1, n):
            raise AssertionError(f"app: load_frames{frame_offset, frame_step, max_frames}")
        return footage

    if announce:
        log("app", f"project_render.load_frames replaced for this call by the "
            f"{n} footage frames rendered on the card (no OpenCV here)")
    with mock.patch.object(ppr, "load_frames", load_frames):
        ppr.project_and_render(
            glb, "footage.mp4", work / "out", height=res[0], width=res[1],
            uv_size=uv, max_frames=n,
            camera_json=DATA / "town_camera_path.json", uv_unwarp=True,
            raster="exact", pos_error_eps="auto", device=dev)
    return work / "out"


def read_app_dir(out, n) -> dict:
    """The four sequences and the shaded GLB's texture that a call wrote,
    decoded by the port's own codec: rgb / normal (n, H, W, 3), mask (n,
    H, W) bool, depth (n, H, W) uint16, texture (U, U, 3), as int64."""
    from worldrenderer_tpu_torch.scene.gltf import _decode_png, _decode_png16, parse_glb

    def seq(name, dec):
        return np.stack([dec((out / name / f"{name}_{i:05d}.png").read_bytes())
                         for i in range(n)]).astype(np.int64)

    for name in ("rgb", "mask", "normal", "depth"):
        if len(list((out / name).glob("*.png"))) != n:
            raise AssertionError(f"app: {out / name} holds no {n} frames")
    tex = _decode_png(parse_glb(out / "projected_shaded.glb").image_bytes(0)[0])
    return dict(rgb=seq("rgb", _decode_png), normal=seq("normal", _decode_png),
                mask=seq("mask", _decode_png)[..., 0] > 0,
                depth=seq("depth", _decode_png16), texture=tex.astype(np.int64))


def app_cpu_ref(pt, footage) -> dict:
    """[app]'s CPU run: the reduced call on the CPU, into CPU_REF_DIR/app."""
    t0 = time.perf_counter()
    out = app_call(footage, CPU_REF_DIR / "app" / "work", APP_CPU_RES,
                   APP_CPU_UV, "cpu")
    return dict(out=str(out), seconds=time.perf_counter() - t0)


def texpipe_inputs(pt, dev, res, work):
    """[texpipe]'s object and views, written into ``work``: bake_scene's mesh
    (uv_sphere_mesh(65, 129), 16,384 triangles) with its seeded 2048²
    texture, scaled to load_mesh's half-extent 0.5 as [paint] scales it, as
    a GLB (the port's save_glb); the pipeline's default six-view ORTHO rig
    over the mesh as load_mesh reads it back, rendered on ``dev`` at res²;
    the views' colour and their normal map (normal * 0.5 + 0.5) as PNG
    directories (the port's encoder). Returns the mesh and the rig."""
    from worldrenderer_tpu_torch.scene.gltf import _encode_png, save_glb

    verts, faces, uv = pt.uv_sphere_mesh(65, 129)
    seeded = torch.rand((BAKE_UV, BAKE_UV, 3),
                        generator=torch.Generator().manual_seed(0)).numpy()
    work.mkdir(parents=True, exist_ok=True)
    glb = work / "object.glb"
    save_glb(glb, vertices=(0.5 * verts).astype(np.float32),
             faces=faces.astype(np.uint32), uv=uv.astype(np.float32),
             texture=seeded)
    mesh = pt.load_mesh(str(glb), device=dev)
    rig = pt.get_orthogonal_camera(
        elevation_deg=np.asarray((0, 0, 0, 0, 89.99, -89.99), np.float32),
        distance=np.full(6, 1.0, np.float32), left=-0.55, right=0.55,
        bottom=-0.55, top=0.55,
        azimuth_deg=np.asarray([a - 90 for a in (0, 90, 180, 270, 180, 180)],
                               np.float32), device=dev)
    out = pt.render(mesh, rig, res, res, device=dev)
    for name, imgs in (("rgb", out.attr), ("normal", out.normal * 0.5 + 0.5)):
        (work / name).mkdir(exist_ok=True)
        for i, img in enumerate(imgs.cpu().numpy()):
            (work / name / f"view_{i}.png").write_bytes(_encode_png(img))
    return mesh, rig


def texpipe_config(pt, mesh, rig, res, uv):
    """The card's TexturePipeline config: DEFAULT_CONFIG's budgets are lossy
    for this mesh's atlas at 4096² (96,520 live entries against a flat cap
    of 4 x 16,384), and camera_projection refuses them; so, as a user
    would, auto_fast_config over the atlas at uv², with the rig's views at
    res² and at the x2 upscale and the painter's anchor rig at its 256² and
    1024² as probes, each checked lossless."""
    from worldrenderer_tpu_torch.baking import smart_paint as ps

    atlas = (atlas_clip(mesh), mesh.t_tex_idx, (uv, uv))
    views = pt.get_clip_space_position(mesh.v_pos, rig.mvp_mtx)
    anchors = pt.get_clip_space_position(
        mesh.v_pos, ps._make_view_selection_cams(device=mesh.v_pos.device).mvp_mtx)
    probes = [(views, mesh.t_pos_idx, (res, res)),
              (views, mesh.t_pos_idx, (2 * res, 2 * res)),
              (anchors, mesh.t_pos_idx, (256, 256)),
              (anchors, mesh.t_pos_idx, (1024, 1024))]
    cfg = pt.auto_fast_config(*atlas, base=pt.FAST_TPU_CONFIG, extra_probes=probes)
    for pos, tri, size in probes + [atlas]:
        chk = cfg._replace(backface_cull=0) if pos is atlas[0] else cfg
        stats = pt.binning_stats(pos, tri, size, chk)
        if not stats["ok"]:
            raise AssertionError(f"texpipe: lossy budgets at {size}: {stats}")
    return cfg


TEXPIPE_MODS = ("rgb", "base colour", "normal map")


def texpipe_call(work, out_dir, uv, mode, dev, marks=None, raster_config=None):
    """TexturePipeline on the ORTHO rig (its defaults), uv ``uv``: rgb with
    ModProcessConfig(view_upscale=True, inpaint_mode=mode) (the cubic x2
    upscale, then the painter for "view"), base colour with the default
    config, the normal map (the rebake), from the inputs texpipe_inputs
    wrote into ``work``; a shaded and a PBR GLB into ``out_dir``. ``marks``
    collects (what, seconds) at each modality's start and at the export.
    ``raster_config`` is the pipeline's (DEFAULT_CONFIG by default).
    Returns (output, pipeline)."""
    from worldrenderer_tpu_torch.pipelines import texture_pipeline as ptp

    tp = ptp.TexturePipeline(raster_config=raster_config, device=dev)
    load = tp.load_packed_images

    def marked(name, fn):
        def call(*a, **k):
            if marks is not None:
                torch.cuda.synchronize()
                marks.append((name(a), time.perf_counter()))
            return fn(*a, **k)
        return call

    with mock.patch.object(tp, "load_packed_images",
                           marked(lambda a: TEXPIPE_MODS[len(marks)], load)), \
            mock.patch.object(ptp, "replace_glb_texture",
                              marked(lambda a: "export", ptp.replace_glb_texture)):
        out = tp(mesh_path=str(work / "object.glb"), save_dir=str(out_dir),
                 save_name="texpipe", uv_size=uv, rgb_path=str(work / "rgb"),
                 rgb_process_config=ptp.ModProcessConfig(view_upscale=True,
                                                         inpaint_mode=mode),
                 base_color_path=str(work / "rgb"),
                 normal_path=str(work / "normal"),
                 camera_projection_type="ORTHO")
    return out, tp


def texpipe_cpu_ref(pt, work) -> dict:
    """[texpipe]'s CPU run: the reduced call on the inputs in ``work``, on
    the CPU, into CPU_REF_DIR/texpipe."""
    t0 = time.perf_counter()
    out, _ = texpipe_call(Path(work), CPU_REF_DIR / "texpipe", TEXPIPE_CPU_UV,
                          "uv", "cpu", raster_config=texpipe_cpu_cfg(pt))
    return dict(uv_proj_rgb=out.uv_proj_rgb, pbr=out.pbr_model_save_path,
                seconds=time.perf_counter() - t0)


def glb_textures(path) -> list:
    """Every image of a GLB, decoded by the port's codec, as int64."""
    from worldrenderer_tpu_torch.scene.gltf import _decode_png, parse_glb

    scene = parse_glb(path)
    return [_decode_png(scene.image_bytes(i)[0]).astype(np.int64)
            for i in range(len(scene.gltf.get("images", [])))]


def lsb_misses(got, want) -> int:
    """Pixels (or texels) where two decoded 8-bit images differ by more
    than 1 in any channel."""
    return int((np.abs(got - want) > 1).reshape(got.shape[0], got.shape[1],
                                                -1).any(-1).sum())


CPU_REFS.update(app=app_cpu_ref, texpipe=texpipe_cpu_ref)


class Slice11:
    """[app]'s and [texpipe]'s CPU runs (CpuReferences), started with
    their inputs, made on the card, before the phases that come first: the
    reduced footage of the town, and the object's GLB with its views at
    TEXPIPE_CPU_RES² in APP_DIR/texpipe_small)."""

    def __init__(self, pt, dev):
        import shutil

        t0 = time.perf_counter()
        shutil.rmtree(APP_DIR, ignore_errors=True)
        self.footage = app_footage(pt, dev, APP_CPU_FRAMES, APP_CPU_RES)
        self.small = APP_DIR / "texpipe_small"
        texpipe_inputs(pt, dev, TEXPIPE_CPU_RES, self.small)
        self.refs = CpuReferences("app", {
            "app": dict(footage=self.footage),
            "texpipe": dict(work=str(self.small))})
        self.setup_s = time.perf_counter() - t0


def app_phase(pt, gb, gc, zc, rk, dev, card, s11) -> dict:
    """Slice 11's application: ``project_and_render`` on the town as the CLI
    runs it (app_call; APP_FRAMES frames at APP_RES, uv APP_UV) on the
    card. The first call is counted and traced (the kernels and idle
    share), with K1's inputs kept: K1 is then held bitwise to its plain
    version on each input shape the call gave it (the host atlas, the
    views, the re-render). A second call gives the wall seconds warm and
    its parts' (from wrappers around the module's own names: process_raw,
    TexturePipeline.__call__, chunk_batch, save_frames,
    save_depth_frames_16bit), and the median |re-render - footage| inside
    the written mask against tests/test_project_render_cli.py's 0.1. Then
    the reduced call on the card against the port's CPU run (decoded with
    the port's codec): mask flips at most 1e-4 of the foreground, rgb and
    normal within 1 LSB outside the flipped pixels, depth within 1 LSB of
    16 bits, the shaded GLB's texture within 1 LSB at all but 1e-4 of
    texels. Returns the launches per kernel."""
    from worldrenderer_tpu_torch import meshproc
    from worldrenderer_tpu_torch.pipelines import project_render as ppr
    from worldrenderer_tpu_torch.pipelines import texture_pipeline as ptp

    t0 = time.perf_counter()
    footage = app_footage(pt, dev, APP_FRAMES, APP_RES)
    foot_s = time.perf_counter() - t0
    work = APP_DIR / "app"

    # The first call: counted, traced (device only), K1's inputs kept.
    kept = {}
    since = reset_counts()
    with k1_inputs_kept(gb, kept):
        first_s = log_profile("app", "project_and_render, the first call "
                              "(device only)", lambda: app_call(
                                  footage, work, APP_RES, APP_UV, dev,
                                  announce=True),
                              reps=1, warm=False, host_ops=False) / 1e3
    counts = read_counts(since)
    # K1 at least once; S1 on a bake's two gathers at least
    if counts["gbuffer_tiles"] < 1 or counts["grid_sample_bilinear"] < 2:
        raise AssertionError(f"app: project_and_render launched {counts}")

    parts = {}

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
            return out
        return call

    with mock.patch.object(meshproc, "process_raw",
                           timed("process_raw", meshproc.process_raw)), \
            mock.patch.object(ptp.TexturePipeline, "__call__",
                              timed("TexturePipeline", ptp.TexturePipeline.__call__)), \
            mock.patch.object(ppr, "chunk_batch", timed("chunk_batch", ppr.chunk_batch)), \
            mock.patch.object(ppr, "save_frames", timed("save_frames", ppr.save_frames)), \
            mock.patch.object(ppr, "save_depth_frames_16bit",
                              timed("save_depth_frames_16bit",
                                    ppr.save_depth_frames_16bit)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        app_call(footage, work, APP_RES, APP_UV, dev)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
    got = read_app_dir(work / "out", APP_FRAMES)
    err = np.abs(got["rgb"] / 255.0 - footage)[got["mask"]]
    median = float(np.median(err))
    log("app", f"project_and_render, town ({APP_FRAMES} frames at "
        f"{APP_RES[0]}x{APP_RES[1]}, uv {APP_UV}, uv_unwarp, raster exact, "
        f"pos_error_eps auto): {call_s:.3f} s per call warm, {first_s:.3f} s "
        f"the first, traced ({card}; the footage rendered in {foot_s:.2f} s, the CPU "
        f"runs' inputs in {s11.setup_s:.2f} s); parts "
        f"(s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; launches {counts}; median |re-render - footage| in the mask "
        f"{median:.4f} over {int(got['mask'].sum())} pixels (limit 0.1)")
    k1_kept_check("app", gc, kept)
    if not (median < 0.1 and got["mask"].mean() > 0.2):
        raise AssertionError("app: the re-render does not reproduce the footage")

    t0 = time.perf_counter()
    small = app_call(s11.footage, APP_DIR / "app_small", APP_CPU_RES, APP_CPU_UV,
                     dev)
    small_s = time.perf_counter() - t0
    ours = read_app_dir(small, APP_CPU_FRAMES)
    t0 = time.perf_counter()
    ref = s11.refs.result("app")
    waited = time.perf_counter() - t0
    want = read_app_dir(Path(ref["out"]), APP_CPU_FRAMES)
    fg = int(want["mask"].sum())
    flips = ours["mask"] != want["mask"]
    keep = ~flips
    rgb_bad = int(((np.abs(ours["rgb"] - want["rgb"]) > 1).any(-1) & keep).sum())
    nrm_bad = int(((np.abs(ours["normal"] - want["normal"]) > 1).any(-1)
                   & keep).sum())
    depth_err = int(np.abs(ours["depth"] - want["depth"]).max())
    tex_bad = lsb_misses(ours["texture"], want["texture"])
    tex_n = want["texture"].shape[0] * want["texture"].shape[1]
    log("app", f"{APP_CPU_FRAMES} frames at {APP_CPU_RES[0]}x{APP_CPU_RES[1]}, "
        f"uv {APP_CPU_UV}, {small_s:.2f} s on the card; card vs CPU "
        f"({ref['seconds']:.1f} s in a process of "
        f"its own, waited {waited:.1f} s): mask flips {int(flips.sum())} of {fg} "
        f"foreground, rgb / normal pixels beyond 1 LSB outside them {rgb_bad} / "
        f"{nrm_bad}, depth max err {depth_err} LSB, shaded texture texels "
        f"beyond 1 LSB {tex_bad} of {tex_n}")
    if not (flips.sum() <= 1e-4 * fg and rgb_bad == 0 and nrm_bad == 0
            and depth_err <= 1 and tex_bad <= 1e-4 * tex_n and fg > 0):
        raise AssertionError("app: the card's run disagrees with the CPU's")
    return {name: counts[name] for name in ("gbuffer_tiles", "grid_sample_bilinear")}


def texpipe_phase(pt, gb, gc, zc, rk, dev, card, s11) -> dict:
    """Slice 11's texture pipeline: TexturePipeline on the MV-Adapter six-view
    ORTHO rig (texpipe_inputs at TEXPIPE_RES², texpipe_call at uv
    TEXPIPE_UV with texpipe_config's budgets: rgb upscaled x2 to 1536² and
    inpainted by the smart painter, base colour, the normal map rebaked) on
    the card, in one call: seconds per call (traced) and per modality, the
    painter's rounds, K1's launches, the kernels and idle share from the
    call's trace, and K1 bitwise against its plain version on each input
    shape the call gave it (the 4096² atlas, the views at 768² and 1536²,
    the painter's renders at 256² and 1024²). Then the reduced call
    (TEXPIPE_CPU_RES², uv TEXPIPE_CPU_UV, inpaint_mode "uv", the upscale
    on) against the port's CPU run: uv_proj_rgb within 1e-4 at all but 1e-4
    of the chart's texels, the PBR GLB's base-colour and normal textures
    within 1 LSB at all but 1e-4 of texels. (The painter's card run is held
    to the CPU by [paint].) Returns the launches per kernel."""
    work = APP_DIR / "texpipe"
    t0 = time.perf_counter()
    mesh, rig = texpipe_inputs(pt, dev, TEXPIPE_RES, work)
    cfg = texpipe_config(pt, mesh, rig, TEXPIPE_RES, TEXPIPE_UV)
    inputs_s = time.perf_counter() - t0

    # One call: counted, timed and traced (device only; the tracer adds
    # about a second to the call's wall), K1's inputs kept. The pipeline's
    # first in the process: the kernels and the allocator are warm from the
    # earlier phases.
    marks, kept, outs = [], {}, []

    def call():
        outs.append(texpipe_call(work, work / "out", TEXPIPE_UV, "view", dev,
                                 marks, raster_config=cfg))
        torch.cuda.synchronize()
        marks.append(("end", time.perf_counter()))

    since = reset_counts()
    with k1_inputs_kept(gb, kept):
        call_s = log_profile("texpipe", "TexturePipeline (device only)", call,
                             reps=1, warm=False, host_ops=False) / 1e3
    counts = read_counts(since)
    # K1 at least once; S1 on a bake's two gathers at least
    if counts["gbuffer_tiles"] < 1 or counts["grid_sample_bilinear"] < 2:
        raise AssertionError(f"texpipe: TexturePipeline launched {counts}")
    (out, tp), = outs
    spans = ", ".join(f"{name} {end - t:.3f}"
                      for (name, t), (_, end) in zip(marks, marks[1:]))
    rounds = len(tp.smart_painter.history)
    log("texpipe", f"TexturePipeline, ORTHO rig, 6 views at {TEXPIPE_RES}² "
        f"(inputs and the config made in {inputs_s:.2f} s), uv {TEXPIPE_UV}: "
        f"{call_s:.3f} s per call, traced ({card}); from each modality's "
        f"start (s): {spans}; painter rounds {rounds}; launches {counts}")
    k1_kept_check("texpipe", gc, kept)
    rgb = out.uv_proj_rgb
    if not (rounds >= 4 and torch.isfinite(rgb).all()
            and len(glb_textures(out.pbr_model_save_path)) == 2):
        raise AssertionError("texpipe: the pipeline's output is malformed")

    t0 = time.perf_counter()
    small, _ = texpipe_call(s11.small, s11.small / "card", TEXPIPE_CPU_UV, "uv",
                            dev, raster_config=texpipe_cpu_cfg(pt))
    small_s = time.perf_counter() - t0
    small_tex = glb_textures(small.pbr_model_save_path)
    t0 = time.perf_counter()
    ref = s11.refs.result("texpipe")
    waited = time.perf_counter() - t0
    mesh = pt.load_mesh(str(s11.small / "object.glb"), device=dev)
    chart = pt.baking.uv_precompute(mesh, TEXPIPE_CPU_UV, TEXPIPE_CPU_UV,
                                    device=dev).uv_mask.cpu()
    n_chart = int(chart.sum())
    rgb_bad = int(((small.uv_proj_rgb.cpu() - ref["uv_proj_rgb"]).abs() > 1e-4)
                  .any(-1)[chart].sum())
    tex_bad = [lsb_misses(a, b) for a, b in zip(small_tex, glb_textures(ref["pbr"]))]
    n_tex = TEXPIPE_CPU_UV ** 2
    log("texpipe", f"6 views at {TEXPIPE_CPU_RES}², uv {TEXPIPE_CPU_UV}, "
        f"inpaint_mode uv, 8x32 tiles, {small_s:.2f} s on the card; card vs "
        f"CPU ({ref['seconds']:.1f} s in a process of "
        f"its own, waited {waited:.1f} s): uv_proj_rgb texels beyond 1e-4 "
        f"{rgb_bad} of {n_chart} chart texels; PBR base colour / normal texels "
        f"beyond 1 LSB {tex_bad} of {n_tex}")
    if not (rgb_bad <= 1e-4 * n_chart and len(tex_bad) == 2
            and max(tex_bad) <= 1e-4 * n_tex and n_chart > 0.2 * n_tex):
        raise AssertionError("texpipe: the card's run disagrees with the CPU's")
    return {name: counts[name] for name in ("gbuffer_tiles", "grid_sample_bilinear")}


SHARD_UV, SHARD_RES, SHARD_CHUNKS = 4096, 768, 8
SWEEP_RES = 512
FIT_STEPS, FIT_LR = 3, 0.01


def shard_scene(pt, dev):
    """bench.py:1013 bench_bake4k's bake: uv_sphere_mesh(65, 129) with a
    SHARD_UV² texture of 0.25, 6 views at SHARD_RES² (elevation 20,
    distance 2.7, fovy 40) of the mesh under a seeded random texture, and
    the config bench.py:941 _projection_auto_cfg sizes for the atlas and
    the views."""
    verts, faces, uv = pt.uv_sphere_mesh(65, 129)
    mesh = pt.mesh_from_arrays(
        verts, faces, v_tex=uv, t_tex_idx=faces,
        texture=np.full((SHARD_UV, SHARD_UV, 3), 0.25, np.float32), device=dev)
    cam = pt.get_camera(elevation_deg=20.0, distance=2.7, fovy_deg=40.0,
                        num_views=6, near=0.1, far=10.0, device=dev)
    seeded = torch.rand((1024, 1024, 3),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    views = pt.render(mesh._replace(texture=seeded), cam, SHARD_RES, SHARD_RES,
                      device=dev).attr
    cfg = pt.auto_fast_config(
        atlas_clip(mesh), mesh.t_tex_idx, (SHARD_UV, SHARD_UV),
        extra_probes=[(pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx),
                       mesh.t_pos_idx, (SHARD_RES, SHARD_RES))])
    return mesh, cam, views, cfg


def peak_gib(fn) -> float:
    """Peak memory allocated on the card by one call of ``fn``, in GiB
    above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def shard_bake_check(pt, gb, gc, zc, rk, dev, card) -> dict:
    """The texel-sharded bake at bench_bake4k's width on a mesh of the one
    card, texel_chunks SHARD_CHUNKS: K1's launches in one counted call
    (its inputs kept and each shape held bitwise to the plain version),
    seconds per bake warm, peak memory at SHARD_CHUNKS chunks against 1,
    kernels and idle share from one traced call, and the result against
    the port's unsharded camera_projection on the card (mask and values bit
    for bit). Returns K1's and S1's launches."""
    from worldrenderer_tpu_torch.baking import projection as pp
    from worldrenderer_tpu_torch.parallel import make_device_mesh

    mesh, cam, views, cfg = shard_scene(pt, dev)
    dm = make_device_mesh(axis_names=("uv",))
    kw = dict(uv_size=SHARD_UV, poisson_blending=False,
              iou_rejection_threshold=None, raster_config=cfg)

    def bake(chunks=SHARD_CHUNKS):
        return pp.camera_projection(views, mesh, cam, device_mesh=dm,
                                    texel_chunks=chunks, **kw)

    kept = {}
    since = reset_counts()
    with k1_inputs_kept(gb, kept):
        out = bake()
    counts = read_counts(since)
    # the atlas and the view renders, once each on the one device; the two
    # gathers of each texel chunk
    if counts != only(gbuffer_tiles=2, grid_sample_bilinear=2 * SHARD_CHUNKS):
        raise AssertionError(f"shard: the sharded bake launched {counts}")
    bake_ms = cuda_ms(bake, 1)
    peak8 = peak_gib(bake)
    peak1 = peak_gib(lambda: bake(1))
    log("shard", f"sharded camera_projection, uv {SHARD_UV}², 6 views at "
        f"{SHARD_RES}², {mesh.num_faces} triangles, mesh {dict(dm.shape)}, "
        f"texel_chunks {SHARD_CHUNKS}: {bake_ms / 1e3:.4f} s per bake warm "
        f"({card}); K1 launches {counts['gbuffer_tiles']}, S1 "
        f"{counts['grid_sample_bilinear']}; peak memory "
        f"{peak8:.3f} GiB at texel_chunks {SHARD_CHUNKS} against {peak1:.3f} "
        f"GiB at 1 (torch.cuda.max_memory_allocated above the inputs)")
    log_profile("shard", "one sharded bake (device only)", bake, reps=1,
                warm=False, host_ops=False)
    k1_kept_check("shard", gc, kept)
    ref = pp.camera_projection(views, mesh, cam, device=dev, **kw)
    mask_diff = int((out.uv_proj_mask != ref.uv_proj_mask).sum())
    bits = {f: int((getattr(out, f).view(torch.int32)
                    != getattr(ref, f).view(torch.int32)).sum())
            for f in ("uv_proj", "uv_depth_grad", "uv_aoi_cos")}
    baked = int(out.uv_proj_mask.sum())
    log("shard", f"against the unsharded camera_projection on the card: mask "
        f"diff {mask_diff} of {baked} texels baked, elements whose bits "
        f"differ {bits}")
    if mask_diff or any(bits.values()) or baked < 0.2 * SHARD_UV ** 2:
        raise AssertionError("shard: the sharded bake differs from the unsharded")
    return {name: counts[name] for name in ("gbuffer_tiles", "grid_sample_bilinear")}


def shard_sweep_checks(pt, gc, zc, rk, dev, card) -> int:
    """render_views_sharded on the headline over the one-card mesh against
    render() bit for bit; SweepRunner on two bucket-padded jobs (the
    headline heightfield, bench_bake4k's sphere at 6 views of SWEEP_RES²):
    each G-buffer bitwise equal to the unpadded render(), the PNGs written,
    seconds per job, and a second runner skipping both. Returns K1's
    launches."""
    import shutil

    from worldrenderer_tpu_torch.parallel import make_device_mesh, runner, sweep

    dm = make_device_mesh()
    head, hcam = headline_scene(pt, dev)
    hcfg = headline_cfg(pt, head, hcam)
    kw = dict(render_attr=False, render_depth=True, render_normal=True,
              raster_config=hcfg)
    since = reset_counts()
    out = sweep.render_views_sharded(head, hcam, 512, 512, dm, **kw)
    launches = read_counts(since)["gbuffer_tiles"]
    ref = pt.render(head, hcam, 512, 512, device=dev, **kw)
    same = all(same_bits(getattr(out, f), getattr(ref, f))
               for f in ("mask", "pos", "depth", "normal"))
    log("shard", f"render_views_sharded, headline over {dict(dm.shape)}: K1 "
        f"launches {launches}, bitwise equal to render() {same}")
    if not same or launches < 1:
        raise AssertionError("shard: render_views_sharded differs from render()")

    verts, faces, uv = pt.uv_sphere_mesh(65, 129)
    sphere = pt.mesh_from_arrays(verts, faces, device=dev)
    scam = pt.get_camera(elevation_deg=20.0, distance=2.7, fovy_deg=40.0,
                         num_views=6, near=0.1, far=10.0, device=dev)
    scfg = headline_cfg(pt, sphere, scam, SWEEP_RES)
    jobs = [runner.RenderJob("headline", head, hcam, 512, 512, kw),
            runner.RenderJob("sphere", sphere, scam, SWEEP_RES, SWEEP_RES,
                             dict(kw, raster_config=scfg))]
    work = APP_DIR / "sweep"
    shutil.rmtree(work, ignore_errors=True)
    run = runner.SweepRunner(str(work), device_mesh=dm)
    since = reset_counts()
    t0 = time.perf_counter()
    results = run.run(jobs)
    sweep_s = time.perf_counter() - t0
    launches += read_counts(since)["gbuffer_tiles"]
    lines = []
    for job, res in zip(jobs, results):
        padded = runner.pad_mesh_to_bucket(job.mesh)
        want = pt.render(job.mesh, job.cam, job.height, job.width, device=dev,
                         **job.render_kwargs)
        same = all(np.array_equal(res[f], getattr(want, f).cpu().numpy())
                   for f in ("mask", "pos", "depth", "normal"))
        pngs = len(list((work / job.name).rglob("*.png")))
        lines.append(f"{job.name} ({job.mesh.num_faces} -> {padded.num_faces} "
                     f"faces) bitwise equal to the unpadded render() {same}, "
                     f"{pngs} PNGs")
        if not same or pngs != 3 * len(job.cam):
            raise AssertionError(f"shard: sweep job {job.name} failed")
    skipped = runner.SweepRunner(str(work), device_mesh=dm).run(jobs)
    log("shard", f"SweepRunner, 2 jobs bucket-padded: {sweep_s / 2:.4f} s per "
        f"job ({card}, PNG writes overlapped); " + "; ".join(lines)
        + f"; a second runner skips both {skipped == [None, None]}")
    if skipped != [None, None]:
        raise AssertionError("shard: the second runner did not resume")
    return launches


def shard_fit_check(pt, gc, zc, rk, dev, card) -> int:
    """texture_fit_step, FIT_STEPS Adam steps (lr FIT_LR) on [diff]'s config4
    fit scene, against the plain loop of fit_loss and torch.optim.Adam on
    the same keywords: the texture's and the loss's largest differences and
    elements whose bits differ (the texture gradient's scatter runs in
    atomic adds, whose order can vary). Returns K1's launches."""
    from worldrenderer_tpu_torch.parallel import sweep

    mesh, cam, cfg, _, target = fit_scene(pt, dev)
    kw = dict(render_attr=True, render_depth=False, render_normal=False,
              attr_background=0.5, raster_config=cfg, device=dev)
    tex = torch.full_like(mesh.texture, 0.5).requires_grad_(True)
    opt = torch.optim.Adam([tex], lr=FIT_LR)
    step = sweep.make_texture_fit_step(opt, FIT_RES, FIT_RES, raster_config=cfg)
    since = reset_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(FIT_STEPS):
        tex, _, loss = step(tex, None, mesh, cam, target)
        losses.append(float(loss))
    fit_s = (time.perf_counter() - t0) / FIT_STEPS
    launches = read_counts(since)["gbuffer_tiles"]
    plain = torch.full_like(mesh.texture, 0.5).requires_grad_(True)
    popt = torch.optim.Adam([plain], lr=FIT_LR)
    plain_losses = []
    for _ in range(FIT_STEPS):
        popt.zero_grad(set_to_none=True)
        loss = fit_loss(pt, mesh, cam, target, plain, kw)
        loss.backward()
        popt.step()
        plain_losses.append(float(loss.detach()))
    err = float((tex.detach() - plain.detach()).abs().max())
    loss_err = max(abs(a - b) / b for a, b in zip(losses, plain_losses))
    log("shard", f"texture_fit_step, config4 at {FIT_RES}², {FIT_STEPS} Adam "
        f"steps: {fit_s:.4f} s per step ({card}), K1 launches {launches}, "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; against the plain loop: "
        f"texture max abs diff {err}, bits differ "
        f"{bits_differ(tex.detach(), plain.detach())}, loss rel diff {loss_err}")
    if not (err <= 1e-5 and loss_err <= 1e-6 and losses[-1] < losses[0]):
        raise AssertionError("shard: texture_fit_step differs from the plain loop")
    return launches


def shard_phase(pt, gb, gc, zc, rk, dev, card) -> dict:
    """Slice 12's multi-device paths on the one card: the texel-sharded
    4096² bake (shard_bake_check), render_views_sharded and SweepRunner
    (shard_sweep_checks), texture_fit_step (shard_fit_check), the validate
    gates (K1 against K3: precision_gate; degenerate_probes) with their
    verdicts, and measure_kernel_mfu on the headline: K1's traced ms per
    frame beside its bound. No process group is started. Returns the
    launches per kernel."""
    from worldrenderer_tpu_torch.utils import roofline, validate

    baked = shard_bake_check(pt, gb, gc, zc, rk, dev, card)
    k1 = baked["gbuffer_tiles"]
    k1 += shard_sweep_checks(pt, gc, zc, rk, dev, card)
    k1 += shard_fit_check(pt, gc, zc, rk, dev, card)

    since = reset_counts()
    gate = validate.precision_gate(quiet=True, device=dev)
    probes = validate.degenerate_probes(quiet=True, device=dev)
    counts = read_counts(since)
    log("shard", f"precision_gate (K1 vs K3, 512²): ok {gate['ok']}; "
        + "; ".join(gate["scenes"]))
    log("shard", f"degenerate_probes (256²): ok {probes['ok']}; "
        + "; ".join(probes["probes"]) + f"; launches of both {counts}")
    if not (gate["ok"] and probes["ok"]) or not counts["zattr_tiles_vpu"]:
        raise AssertionError("shard: a validate gate failed")

    mesh, cam = headline_scene(pt, dev)
    cfg = headline_cfg(pt, mesh, cam)
    pos = pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    work = roofline.kernel_counts(pos, mesh.t_pos_idx, (512, 512), cfg)
    mfu = roofline.measure_kernel_mfu(
        lambda i: pt.render(mesh, cam, 512, 512, render_attr=False,
                            render_depth=False, render_normal=True,
                            raster_config=cfg, device=dev), work)
    inputs, dims, _ = gb._k1_inputs(pos, mesh.t_pos_idx, None, 512, 512, cfg)
    bound, by, _ = k1_bound_ms(inputs, dims)
    if mfu is None:
        raise AssertionError("shard: measure_kernel_mfu found no K1 in its trace")
    log("shard", f"measure_kernel_mfu, headline ({card}): K1 "
        f"{mfu['kernel_ms_per_frame']:.4f} ms per frame (6 views) from the "
        f"trace, bound {bound:.5f} ms by {by}; issued "
        f"{mfu['issued_gop_per_frame']:.3f} G fp32 instructions "
        f"({100 * mfu['util_issued']:.1f}% of the rate), useful "
        f"{mfu['useful_gop_per_frame']:.3f} G ({100 * mfu['util_useful']:.1f}%), "
        f"floor ratio {mfu['floor_ratio']:.2f}")
    return {"gbuffer_tiles": k1 + counts["gbuffer_tiles"],
            "zattr_tiles_vpu": counts["zattr_tiles_vpu"],
            "grid_sample_bilinear": baked["grid_sample_bilinear"]}


MULTI_CHUNKS = 2
FIT_RANK_STEPS = 2


def fit_rank(rank: int, world: int, port: int, out: str) -> int:
    """``python3 chip_smoke.py --fit-rank RANK WORLD PORT OUT``: one rank of
    multi_card_readings' data-parallel fit, on card RANK: an nccl group of
    WORLD processes at tcp://localhost:PORT, FIT_RANK_STEPS texture_fit_step
    calls on [diff]'s config4 fit scene (each rank renders its block of
    the 4 views), rank 0 saving the texture and the losses to OUT."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import worldrenderer_tpu_torch as pt
    from worldrenderer_tpu_torch.parallel import dist, sweep

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.initialize_distributed(f"localhost:{port}", world, rank, device=dev)
    mesh, cam, cfg, _, target = fit_scene(pt, dev)
    tex = torch.full_like(mesh.texture, 0.5).requires_grad_(True)
    opt = torch.optim.Adam([tex], lr=FIT_LR)
    step = sweep.make_texture_fit_step(opt, FIT_RES, FIT_RES, raster_config=cfg)
    losses = []
    for _ in range(FIT_RANK_STEPS):
        tex, _, loss = step(tex, None, mesh, cam, target)
        losses.append(float(loss))
    dist.barrier()
    if rank == 0:
        np.savez(out, tex=tex.detach().cpu().numpy(), losses=np.asarray(losses))
    torch.distributed.destroy_process_group()
    return 0


def multi_card_readings() -> int:
    """``python3 chip_smoke.py --multi-card``: the multi-device paths across
    every card of the machine (four on a four-card machine): the
    sharded bake of [shard] (uv 4096, 6 views at 768²) over a mesh of all
    cards at texel_chunks MULTI_CHUNKS against the same bake on a mesh of
    card 0 (bits, seconds, each card's peak memory); render_views_sharded
    of the headline at 8 views over all cards against render() on card 0;
    and the data-parallel texture_fit_step in one nccl process per card
    (fit_rank) against the one-process step on card 0."""
    import shutil
    import socket

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import worldrenderer_tpu_torch as pt
    from worldrenderer_tpu_torch.baking import projection as pp
    from worldrenderer_tpu_torch.ops import _build
    from worldrenderer_tpu_torch.parallel import make_device_mesh, sweep

    n = torch.cuda.device_count()
    if n < 2:
        print("chip_smoke --multi-card: fewer than 2 CUDA devices", file=sys.stderr)
        return 1
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split("\n")
    log("multi", f"{n} cards: " + "; ".join(c for c in cards if c))
    _build.build(["gbuffer_tiles", "raster_zid_tiles", "zattr_tiles"])
    dev = torch.device("cuda", 0)

    def sync_all():
        for i in range(n):
            torch.cuda.synchronize(i)

    mesh, cam, views, cfg = shard_scene(pt, dev)
    kw = dict(uv_size=SHARD_UV, poisson_blending=False,
              iou_rejection_threshold=None, raster_config=cfg,
              texel_chunks=MULTI_CHUNKS)
    results, times, peaks = {}, {}, {}
    for name, dm in (("card 0", make_device_mesh(axis_names=("uv",),
                                                 devices=[dev])),
                     (f"{n} cards", make_device_mesh(axis_names=("uv",)))):
        pp.camera_projection(views, mesh, cam, device_mesh=dm, **kw)  # warm
        sync_all()
        for i in range(n):
            torch.cuda.reset_peak_memory_stats(i)
        t0 = time.perf_counter()
        results[name] = pp.camera_projection(views, mesh, cam, device_mesh=dm, **kw)
        sync_all()
        times[name] = time.perf_counter() - t0
        peaks[name] = [torch.cuda.max_memory_allocated(i) / 2 ** 30 for i in range(n)]
    one, many = results["card 0"], results[f"{n} cards"]
    bits = {f: int((getattr(one, f).view(torch.int32)
                    != getattr(many, f).view(torch.int32)).sum())
            for f in ("uv_proj", "uv_depth_grad", "uv_aoi_cos")}
    mask_diff = int((one.uv_proj_mask != many.uv_proj_mask).sum())
    log("multi", f"sharded bake, uv {SHARD_UV}², texel_chunks {MULTI_CHUNKS}: "
        + "; ".join(f"{k} {times[k]:.4f} s, peak GiB per card "
                    + ", ".join(f"{p:.3f}" for p in peaks[k]) for k in times)
        + f"; {n} cards against card 0: mask diff {mask_diff}, elements whose "
        f"bits differ {bits}")
    if mask_diff or any(bits.values()):
        raise AssertionError("multi: the bake over the cards differs from card 0's")

    head, hcam = headline_scene(pt, dev, views=8)
    hcfg = headline_cfg(pt, head, hcam)
    rkw = dict(render_attr=False, render_depth=True, render_normal=True,
               raster_config=hcfg)
    dm = make_device_mesh()
    sweep.render_views_sharded(head, hcam, 512, 512, dm, **rkw)
    sync_all()
    t0 = time.perf_counter()
    out = sweep.render_views_sharded(head, hcam, 512, 512, dm, **rkw)
    sync_all()
    split_s = time.perf_counter() - t0
    ref = pt.render(head, hcam, 512, 512, device=dev, **rkw)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ref = pt.render(head, hcam, 512, 512, device=dev, **rkw)
    torch.cuda.synchronize(dev)
    one_s = time.perf_counter() - t0
    same = all(same_bits(getattr(out, f), getattr(ref, f))
               for f in ("mask", "pos", "depth", "normal"))
    log("multi", f"render_views_sharded, headline at 8 views over {n} cards: "
        f"{split_s * 1e3:.2f} ms against {one_s * 1e3:.2f} ms on card 0 (host "
        f"clock, one warm call each), bitwise equal to render() {same}")
    if not same:
        raise AssertionError("multi: render_views_sharded differs from render()")

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_path = CPU_REF_DIR / "fit_rank0.npz"
    CPU_REF_DIR.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--fit-rank", str(r), str(n), str(port),
                               str(out_path)]) for r in range(n)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    group_s = time.perf_counter() - t0
    if any(rcs):
        raise AssertionError(f"multi: the fit ranks exited {rcs}")
    got = np.load(out_path)
    mesh4, cam4, cfg4, _, target = fit_scene(pt, dev)
    tex = torch.full_like(mesh4.texture, 0.5).requires_grad_(True)
    opt = torch.optim.Adam([tex], lr=FIT_LR)
    step = sweep.make_texture_fit_step(opt, FIT_RES, FIT_RES, raster_config=cfg4)
    losses = []
    for _ in range(FIT_RANK_STEPS):
        tex, _, loss = step(tex, None, mesh4, cam4, target)
        losses.append(float(loss))
    err = float(np.abs(got["tex"] - tex.detach().cpu().numpy()).max())
    loss_err = float(np.max(np.abs(got["losses"] - losses) / np.asarray(losses)))
    log("multi", f"texture_fit_step, config4 at {FIT_RES}², {n} nccl ranks "
        f"(a view each), {FIT_RANK_STEPS} Adam steps ({group_s:.1f} s with "
        f"the processes' start): against one process on card 0, texture max "
        f"abs diff {err}, loss rel diff {loss_err}")
    if not (err <= 1e-5 and loss_err <= 1e-6):
        raise AssertionError("multi: the data-parallel step differs")
    shutil.rmtree(CPU_REF_DIR, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
    return 0


def k1_k4_readings(port_root: Path) -> int:
    """``python3 chip_smoke.py --k1-k4 ROOT``: only the tile kernels' times
    (K1's ``[k1] balance`` on the headline and config4, K3's ``[k3]
    reduction``, K2 on workload 1 and K4 on workload 1 and the atlas, each
    as given and with every count 0), with the port imported from ROOT, a
    directory that holds a ``worldrenderer_tpu_torch`` package (such as a
    parent commit unpacked by ``git archive`` into a git-ignored
    directory). Two versions are compared in turns on one card: ``for d in
    _parent . . _parent; do python3 chip_smoke.py --k1-k4 $d; done``; their
    ``[k1k4] digest`` lines, of the kernels' output bits, must agree."""
    global cuda_ms
    sys.path.insert(0, str(port_root.resolve()))
    import worldrenderer_tpu_torch as pt
    from worldrenderer_tpu_torch.ops import gbuffer as gb
    from worldrenderer_tpu_torch.ops import gbuffer_cuda as gc
    from worldrenderer_tpu_torch.ops import raster_zid_cuda as rk
    pr = importlib.import_module("worldrenderer_tpu_torch.ops.rasterize")
    from worldrenderer_tpu_torch.ops import zattr_cuda as zc
    from worldrenderer_tpu_torch.probes import cuda_ms

    if Path(pt.__file__).resolve().parent.parent != port_root.resolve():
        print(f"chip_smoke: the port was not imported from {port_root}",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = smi()
    log("env", f"{card}; the port from {port_root}")
    mesh, cam = headline_scene(pt, dev)
    (head, hdims), _ = k1_inputs_for(pt, gb, mesh, cam, 512)
    (c4, c4dims), _ = textured_kernel_inputs(pt, gb, dev)
    sph, scam = sphere_scene(pt, dev)
    spos = pt.get_clip_space_position(sph.v_pos, scam.mvp_mtx)
    cfg = pt.DEFAULT_CONFIG
    zin, zdims, _ = gb._zattr_inputs(spos, sph.t_pos_idx, sph.v_nrm, 512, 512,
                                     cfg)
    kin = pr._zid_inputs(spos, sph.t_pos_idx, 512, 512, cfg)[1]
    atlas = pr._zid_inputs(atlas_clip(sph), sph.t_tex_idx, 2048, 2048, cfg)[1]
    kdims = (cfg.tile_h, cfg.tile_w, cfg.chunk)
    k1_balance(gc, head, hdims, card, "headline")
    k1_balance(gc, c4, c4dims, card, "config4")
    k3_reduction(zc, zin, zdims, card)
    k2_k4_times(zc, rk, zin, zdims, kin, atlas, kdims, card)
    h = hashlib.sha256()
    for t in (*gc.gbuffer_tiles(*head, *hdims), *gc.gbuffer_tiles(*c4, *c4dims),
              *zc.zattr_tiles_vpu(*zin, *zdims), *zc.zattr_tiles(*zin, *zdims),
              *rk.raster_zid_tiles(*kin, *kdims),
              *rk.raster_zid_tiles(*atlas, *kdims)):
        h.update(t.contiguous().cpu().numpy().tobytes())
    log("k1k4", f"digest of K1's, K2's, K3's and K4's outputs "
        f"{h.hexdigest()[:16]}")
    return 0


def probe_readings(port_root: Path) -> int:
    """``python3 chip_smoke.py --probes ROOT``: only P1's and P3's times
    (``probe_times``: each wrapper's and each kernel's alone), with the
    port imported from ROOT, to compare two versions in turns on one card
    as ``--k1-k4`` does; ``[probes] digest`` lines hold P3's output bits,
    which every version must agree on."""
    global cuda_ms
    sys.path.insert(0, str(port_root.resolve()))
    import worldrenderer_tpu_torch as pt
    from worldrenderer_tpu_torch.ops import gbuffer as gb
    from worldrenderer_tpu_torch.probes import chunk_stream as p1
    from worldrenderer_tpu_torch.probes import cuda_ms
    from worldrenderer_tpu_torch.probes import smem_gather as p3

    if Path(pt.__file__).resolve().parent.parent != port_root.resolve():
        print(f"chip_smoke: the port was not imported from {port_root}",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = smi()
    mesh, cam = headline_scene(pt, dev)
    (head_k1, hdims), _ = k1_inputs_for(pt, gb, mesh, cam, 512)
    _, th, tw, n_ty, n_tx, c = hdims[:6]  # a parent's dims may lack sub
    x = torch.randn((head_k1[2].shape[0], 8, head_k1[0].shape[2]),
                    generator=torch.Generator(device=dev).manual_seed(11),
                    device=dev)
    times = probe_times(p1, p3, (x, head_k1[2], head_k1[3]),
                        (n_ty * n_tx, th, tw, c), dev)
    log("probes", f"{card}; the port from {port_root}: " + ", ".join(
        f"{k} {v if v is None else round(v, 5)} ms" for k, v in times.items()))
    h = hashlib.sha256()
    for axis in (1, 0):
        xs, idx = p3.probe_inputs(axis, dev)
        h.update(p3.smem_gather(xs, idx, p3.T, axis).cpu().numpy().tobytes())
    log("probes", f"digest of P3's outputs {h.hexdigest()[:16]}")
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--k1-k4":
        return k1_k4_readings(Path(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--probes":
        return probe_readings(Path(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--cpu-refs":
        return cpu_references(sys.argv[2])
    if len(sys.argv) == 2 and sys.argv[1] == "--sample":
        return sample_readings()
    if len(sys.argv) == 2 and sys.argv[1] == "--multi-card":
        return multi_card_readings()
    if len(sys.argv) == 6 and sys.argv[1] == "--fit-rank":
        return fit_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                        sys.argv[5])
    # The port must come from the checkout this script sits in (first on
    # sys.path), never from an installed copy: alone in a directory, the
    # script fails.
    root = Path(__file__).resolve().parent
    if not (root / "worldrenderer_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no worldrenderer_tpu_torch package in {root}",
              file=sys.stderr)
        return 1
    # cuda_ms, the CUDA-event timer every phase uses, is the probes' own;
    # the peaks, instruction counts and K1's bound are the roofline's.
    global cuda_ms, PEAK_FP32_FLOPS, PEAK_FP32_INSTR, PEAK_BYTES
    global K1_OPS_PER_PAIR, OPS_PER_ENTRY_ROW, OPS_PER_ENTRY_COL
    global TILE_OPS_PER_PAIR, k1_bound_ms
    import worldrenderer_tpu_torch as pt
    from worldrenderer_tpu_torch import meshproc
    from worldrenderer_tpu_torch.ops import _build
    from worldrenderer_tpu_torch.ops import gbuffer as gb
    from worldrenderer_tpu_torch.ops import gbuffer_cuda as gc
    from worldrenderer_tpu_torch.ops import raster_zid_cuda as rk
    pr = importlib.import_module("worldrenderer_tpu_torch.ops.rasterize")
    from worldrenderer_tpu_torch.ops import zattr_cuda as zc
    from worldrenderer_tpu_torch.probes import cuda_ms
    from worldrenderer_tpu_torch.utils.roofline import (
        H100_HBM_BYTES_PER_S as PEAK_BYTES,
        H100_PEAK_FP32_FLOPS as PEAK_FP32_FLOPS,
        H100_PEAK_FP32_INSTR as PEAK_FP32_INSTR,
        K1_OPS_PER_PAIR,
        OPS_PER_ENTRY_COL,
        OPS_PER_ENTRY_ROW,
        TILE_OPS_PER_PAIR,
        k1_bound_ms,
    )

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # The CPU runs that [main], [flat], [attr] and [diff] hold the card
    # against, beside everything else from the start.
    early = CpuReferences("early", dict.fromkeys(("main", "flat", "attr", "diff")))
    try:
        return run_all(pt, meshproc, _build, gb, gc, rk, pr, zc, dev, early,
                       t_start)
    finally:
        early.close()


def run_all(pt, meshproc, _build, gb, gc, rk, pr, zc, dev, early,
            t_start) -> int:
    """The build, then every phase."""
    card = smi()
    log("env", card)
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = ["gbuffer_tiles", "raster_zid_tiles", "zattr_tiles",
            "grid_sample_bilinear", "probe_chunk_stream", "probe_transpose",
            "probe_smem_gather"]
    # The host's meshproc library (g++), and the same without FMA
    # contraction for [lod], build beside the kernels (nvcc).
    pool = concurrent.futures.ThreadPoolExecutor(2)
    meshproc_builds = [pool.submit(meshproc._get_lib, flags) for flags in
                       (meshproc.GXX_FLAGS, meshproc.NO_CONTRACT)]
    logs = _build.build(libs)  # one nvcc per source, all started together
    log("build", f"{', '.join(libs)} built in {time.perf_counter() - t0:.2f} s")
    for build in meshproc_builds:
        build.result()  # raises if g++ failed
    pool.shutdown()
    log("build", f"meshproc (g++, {meshproc._target().name}) ready at "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        for line in logs[lib].splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{lib}: {line.strip()}")

    def mark(what):
        log("time", f"{what} done at {time.perf_counter() - t_start:.1f} s")

    mark("build")
    # Slice 7's, 8's and 10's paths, each driven with every count set to 0
    # just before it and read just after, with its wall seconds. Slice 10's
    # inputs for [warp] and [paint] are made before [bake], which starts
    # their CPU runs beside the phases from there on.
    s10, s11 = [], []

    def slice10():
        if not s10:
            s10.append(Slice10(pt, dev))
        return s10[0]

    def slice11():
        if not s11:
            s11.append(Slice11(pt, dev))
        return s11[0]

    # Slice 11's CPU runs start with [town], the first of these phases.
    late = {
        "town": lambda: (slice11(), town_phase(pt, gb, gc, zc, rk, dev, card))[1],
        "tiny": lambda: tiny_phase(pt, gb, pr, gc, zc, rk, dev, card),
        "lod": lambda: lod_phase(pt, gb, gc, zc, rk, dev, card),
        "subtile": lambda: subtile_phase(pt, gb, gc, zc, rk, dev, card),
        "bake": lambda: (slice10(), bake_phase(pt, gb, gc, zc, rk, dev, card))[1],
        "bake_full": lambda: bake_full_phase(pt, gb, gc, zc, rk, dev, card),
        "diff": lambda: diff_phase(pt, gb, gc, zc, rk, dev, card, early),
        "warp": lambda: warp_phase(pt, gb, gc, zc, rk, dev, card, slice10()),
        "paint": lambda: paint_phase(pt, gb, gc, zc, rk, dev, card, slice10()),
        "app": lambda: app_phase(pt, gb, gc, zc, rk, dev, card, slice11()),
        "texpipe": lambda: texpipe_phase(pt, gb, gc, zc, rk, dev, card, slice11()),
        "shard": lambda: shard_phase(pt, gb, gc, zc, rk, dev, card),
    }
    try:
        return run_phases(pt, gb, pr, gc, zc, rk, dev, card, late, mark,
                          t_start, early)
    finally:
        import shutil

        for s in s10 + s11:
            s.refs.close()
        shutil.rmtree(APP_DIR, ignore_errors=True)


def run_phases(pt, gb, pr, gc, zc, rk, dev, card, late, mark, t_start,
               early) -> int:
    """Every phase after the build."""
    camera_phase(pt, dev)

    # Phase 3: K1 against its plain version on the card.
    mesh, cam = headline_scene(pt, dev)
    head_inputs, head_cfg = k1_inputs_for(pt, gb, mesh, cam, 512)
    head_k1, head_dims = head_inputs
    big_mesh, big_cam = headline_scene(pt, dev, n=188)
    assert big_mesh.num_faces == 69_938
    big_k1, big_dims = k1_inputs_for(pt, gb, big_mesh, big_cam, 1024)[0]
    syn_k1, syn_dims = synthetic_k1_inputs(dev)
    tie_k1, tie_dims, tie_winners = synthetic_k1_tie_inputs(dev)
    # Workload 3's K1 inputs: classic rasterize's uv mode at DEFAULT_CONFIG
    # (tiles of 32x128, so the 16-pixels-per-thread instance).
    uv_k1, uv_dims, _ = gb._k1_inputs(
        pt.get_clip_space_position(mesh.v_pos, cam.mvp_mtx), mesh.t_pos_idx,
        None, 512, 512, pt.DEFAULT_CONFIG, uv_mode=True)
    max_err = 0.0
    for name, inputs, dims in (("headline", head_k1, head_dims),
                               ("grid188_1024", big_k1, big_dims),
                               ("synthetic", syn_k1, syn_dims),
                               # a width that is no power of two: the kernel
                               # instance with a pixel per group per thread
                               ("synthetic_w96", syn_k1,
                                syn_dims[:2] + (96,) + syn_dims[3:]),
                               ("ties", tie_k1, tie_dims),
                               ("classic_uv", uv_k1, uv_dims)):
        err = k1_against_plain(gc, inputs, dims)
        max_err = max(max_err, err)
        log("k1", f"{name}: live chunks {int(inputs[3].sum())}, bitwise "
            f"equal to the plain version (max abs err {err})")
    (c4_k1, c4_dims), (tex_k2, tex_dims) = textured_kernel_inputs(pt, gb, dev)
    err = k1_against_plain(gc, c4_k1, c4_dims)
    max_err = max(max_err, err)
    log("k1", f"config4 (1024², n_vals {c4_dims[0]}): live chunks "
        f"{int(c4_k1[3].sum())}, bitwise equal to the plain version (max abs "
        f"err {err})")
    tie_ids = gc.gbuffer_tiles(*tie_k1, *tie_dims)[1][0, :16, :128].cpu()
    for what, rows, cols in (("+0 first", slice(0, 8), slice(0, 64)),
                             ("-0 first", slice(0, 8), slice(64, 128)),
                             ("-0.5 first", slice(8, 16), slice(0, 128))):
        if not (tie_ids[rows, cols] == int(tie_k1[1][0, tie_winners[what]])).all():
            raise AssertionError(f"K1 ties: {what} lost its tie")
    log("k1", "ties: +0 then -0, -0 then +0 and -0.5 ties across a 10-chunk "
        "tile each keep the first entry in list order")
    k1_balance(gc, head_k1, head_dims, card, "headline")
    k1_balance(gc, c4_k1, c4_dims, card, "config4")
    c4_ms = cuda_ms(lambda: gc.gbuffer_tiles(*c4_k1, *c4_dims), 50)
    c4_bound, c4_by, c4_live = k1_bound_ms(c4_k1, c4_dims)
    log("k1", f"config4 ({card}): {c4_ms:.4f} ms, bound {c4_bound:.5f} ms by "
        f"{c4_by} ({c4_live} live chunks)")
    without_sync(lambda: gc.gbuffer_tiles(*head_k1, *head_dims))
    log("sync", "K1's wrapper ran under set_sync_debug_mode('error'): no "
        "device-to-host sync")
    log_occupancy("k1", gc.occupancy(head_dims[5], head_dims[2]), head_dims[5])
    mark("k1 checks")
    tile_entries = tile_kernel_checks(pt, gb, pr, zc, rk, dev, card)
    err = bitwise_against_plain("zattr_tiles", zc.zattr_tiles(*tex_k2, *tex_dims),
                                zc.zattr_tiles_plain(*tex_k2, *tex_dims))
    tile_entries["zattr_tiles"]["max_abs_err"] = max(
        tile_entries["zattr_tiles"]["max_abs_err"], err)
    log("k2", f"sphere_textured (n_vals {tex_dims[0]}): {int(tex_k2[0].shape[0])} "
        f"tiles, bitwise equal to the plain version (max abs err {err})")
    mark("k2-k4 checks")
    probe_entries = probe_checks(head_k1, head_dims, dev, card)
    mark("probe checks")

    # Phase 4: the main path through render(), launch counts around it.
    kw = dict(render_attr=False, render_depth=False, render_normal=True,
              raster_config=head_cfg)
    since = reset_counts()
    out = pt.render(mesh, cam, 512, 512, device=dev, **kw)
    launches = read_counts(since)["gbuffer_tiles"]
    if launches < 1:
        raise AssertionError("render() did not launch K1")
    log("main", f"render(): K1 launches {launches}")

    cpu = early.result("main")
    ref = cpu["render"]
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
    id_diff = int((g_gpu.tri_id.cpu() != cpu["tri_id"]).sum())
    log("main", f"tri_id diff GPU vs CPU: {id_diff} (the CPU's run "
        f"{cpu['seconds']:.1f} s in a process of its own)")
    if id_diff > 1e-4 * fg or head_cfg != cpu["cfg"]:
        raise AssertionError("GPU triangle ids disagree with the CPU")
    spread_report(pt, mesh, cam, dev, kw, out, ref)
    verts, faces, _ = pt.uv_sphere_mesh(65, 129)  # bake_scene's mesh
    normals_check(pt, [("headline", mesh), ("bake sphere", pt.mesh_from_arrays(
        verts, faces, device=dev))], dev, nrm_err)

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

    # Slice 2's paths, each driven with every count set to 0 just before it
    # and read just after.
    mark("main")
    tile_launches = tiles_phase(pt, gc, zc, rk, dev, card)
    mark("tiles")
    tile_launches["raster_zid_tiles"] += atlas_phase(pt, gc, zc, rk, dev, card)
    launches += classic_phase(pt, gc, zc, rk, dev, card)
    mark("atlas, classic")
    for name, n in flat_backends_phase(pt, gb, gc, zc, rk, dev, card,
                                       head_cfg, early).items():
        tile_launches[name] += n
    # Slice 3's paths, the same way.
    mark("flat")
    launches += texture_phase(pt, gb, gc, zc, rk, dev, card)
    mark("texture")
    for name, n in attr_phase(pt, gc, zc, rk, dev, card, early).items():
        tile_launches[name] += n
    mark("attr")
    launches += chunk_phase(pt, gc, zc, rk, dev, card)
    mark("chunk")
    launches += ssaa_phase(pt, gc, zc, rk, dev, card)
    mark("ssaa")
    for name, n in probes_phase().items():
        probe_entries[name]["launches"] = n
    t_phase = time.perf_counter()
    s1_entry = sample_phase(pt, dev, card)
    log("sample", f"phase ran {time.perf_counter() - t_phase:.1f} s")
    mark("sample")
    for phase, call in late.items():
        t_phase = time.perf_counter()
        for name, n in call().items():
            if name == "gbuffer_tiles":
                launches += n
            elif name == "grid_sample_bilinear":
                s1_entry["launches"] += n
            else:
                tile_launches[name] += n
        log(phase, f"phase ran {time.perf_counter() - t_phase:.1f} s")
    for name, entry in tile_entries.items():
        entry["launches"] = tile_launches[name]

    log("time", f"chip_smoke ran {time.perf_counter() - t_start:.1f} s")
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
    }] + list(tile_entries.values()) + [s1_entry]
        + list(probe_entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
