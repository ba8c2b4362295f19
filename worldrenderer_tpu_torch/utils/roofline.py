"""Roofline accounting for the flat-path G-buffer kernel K1
(``csrc/gbuffer_tiles.cu``); PyTorch counterpart of
``worldrenderer_tpu/utils/roofline.py``, with the H100's figures and K1's
own work model in place of the TPU's MXU pass model.

The work model counts K1's fp32 instructions. K1 is built with
``-fmad=false``, so each multiply, add and compare is an instruction of its
own and the card issues at most one per lane per cycle, half the
FMA-counted peak. A live (entry, pixel) pair costs ``K1_OPS_PER_PAIR``
instructions (four planes of a multiply and two adds, five compares) and
each entry costs ``OPS_PER_ENTRY_ROW`` more per row of a tile's pixels
(the b-terms, shared along a row). Two counts:

* ``useful`` — the binned (tile, triangle) entries alone;
* ``issued`` — every entry of every live chunk, the padding of each
  tile's last chunk included: what the kernel scans.

``k1_bound_ms`` is the least time for K1's work on given inputs, the
larger of the issued instructions over the instruction rate and the bytes
K1 must move over the memory rate. ``measure_kernel_mfu`` sets a traced
K1 time beside those counts.

Peaks are NVIDIA's published H100 SXM figures: 67 TFLOP/s fp32 outside the
tensor cores (an FMA counted as two operations) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import collections
import gzip
import json
import os
import tempfile

import numpy as np

__all__ = [
    "H100_PEAK_FP32_FLOPS",
    "H100_PEAK_FP32_INSTR",
    "H100_HBM_BYTES_PER_S",
    "exclusive_times",
    "kernel_counts",
    "kernel_flops",
    "k1_bound_ms",
    "measure_kernel_mfu",
]

H100_PEAK_FP32_FLOPS = 67e12
H100_PEAK_FP32_INSTR = H100_PEAK_FP32_FLOPS / 2
H100_HBM_BYTES_PER_S = 3.35e12

# fp32 instructions per (entry, pixel) pair in K1's scan. A thread's pixels
# share a row, so each plane's b * ly is one multiply per (entry, row) and a
# pair costs four planes of (a multiply and two adds); the best z starts
# just above 1, so z < zbest also tests z <= 1 and a pair makes five
# compares (e0, e1, e2 >= 0, z >= -1, z < zbest).
K1_OPS_PER_PAIR = 17
# fp32 instructions per (entry, row of a tile's pixels) in K1's and K3's
# scans: the four b-terms.
OPS_PER_ENTRY_ROW = 4
# fp32 instructions per (entry, column of a tile's pixels) in K2's and K4's
# scans: the four a-terms a * lx.
OPS_PER_ENTRY_COL = 4
# fp32 instructions per (entry, pixel) pair in K2's, K3's and K4's scans:
# four planes of (an FMA and an add) and five compares (e0, e1, e2 >= 0,
# z >= -1, z against the best z, which starts at or just above 1, so that
# compare also tests z <= 1). K2's and K4's planes are fma(b, ly, a*lx) + g
# with a * lx shared along a column (OPS_PER_ENTRY_COL); K3's are
# fma(lx, a, ly*b) + g with ly * b shared along a row (OPS_PER_ENTRY_ROW).
TILE_OPS_PER_PAIR = 13

# Trace categories of the card's own work in a torch.profiler trace.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


def _load_trace(trace_path):
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def exclusive_times(trace_path):
    """Per-op exclusive device time from a Chrome trace (``torch.profiler``'s
    ``export_chrome_trace``, or a TensorBoard ``trace.json.gz``):
    {name: seconds} summed over the device's events, each event's exclusive
    time its duration less its direct children's, one stack sweep per
    (pid, tid) lane. A device event is one of the card's trace categories
    (kernels, copies, sets, annotations) or lies on a process whose name
    marks a device. A child that outlasts its parent counts only inside the
    parent's span, so no time is ever negative."""
    events = _load_trace(trace_path)
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e.get("pid")] = str(e.get("args", {}).get("name", ""))
    device_pids = {
        pid for pid, name in pid_names.items()
        if any(k in name for k in ("GPU", "TPU", "Device")) or "/device:" in name.lower()
    }
    lanes = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") not in _DEVICE_CATS and e.get("pid") not in device_pids:
            continue
        lanes[(e.get("pid"), e.get("tid"))].append(e)

    excl = collections.Counter()

    def close(node):
        excl[node["name"]] += max(node["dur"] - node["children"], 0.0) / 1e6

    for lane in lanes.values():
        lane.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack = []  # (end, node)
        for e in lane:
            ts, dur = float(e["ts"]), float(e["dur"])
            while stack and stack[-1][0] <= ts:
                close(stack.pop()[1])
            if stack:
                parent_end = stack[-1][0]
                stack[-1][1]["children"] += min(ts + dur, parent_end) - ts
            stack.append((ts + dur, {"name": e.get("name", "?"), "dur": dur,
                                     "children": 0.0}))
        while stack:
            close(stack.pop()[1])
    return excl


def kernel_counts(pos_clip, tri, resolution, config):
    """Exact per-batch work counts of the flat path's binning: live (tile,
    triangle) entries and chunk trips (ceil(count / chunk) per tile), from
    the same ``_bin_flat`` the render performs (no rasterization)."""
    import torch

    from ..ops.gbuffer import _bin_flat_config
    from ..ops.rasterize import _clip_corners, _triangle_setup_t

    height, width = resolution
    with torch.no_grad():
        setup = _triangle_setup_t(_clip_corners(pos_clip, tri), width, height,
                                  config.backface_cull)
        counts = _bin_flat_config(setup, width, height, config)[3].cpu().numpy()
    return {
        "live_entries": int(counts.sum()),
        "chunk_trips": int(np.ceil(counts / config.chunk).sum()),
        "pixels_per_tile": config.tile_h * config.tile_w,
        "tile_h": config.tile_h,
        "chunk": config.chunk,
    }


def kernel_flops(counts):
    """(useful, issued) K1 fp32 instructions for ``kernel_counts``' work:
    per entry, ``K1_OPS_PER_PAIR`` per pixel and ``OPS_PER_ENTRY_ROW`` per
    tile row; useful over the binned entries, issued over every entry of
    every chunk trip."""
    per_entry = (counts["pixels_per_tile"] * K1_OPS_PER_PAIR
                 + counts["tile_h"] * OPS_PER_ENTRY_ROW)
    useful = counts["live_entries"] * per_entry
    issued = counts["chunk_trips"] * counts["chunk"] * per_entry
    return useful, issued


def k1_bound_ms(inputs, dims) -> tuple:
    """Least time the card could take for K1's work on these inputs
    ``(recs, ids, start_chunks, n_chunks)`` with static ``dims`` (n_vals,
    tile_h, tile_w, n_ty, n_tx, c[, sub]): the larger of the live chunks'
    instructions (``K1_OPS_PER_PAIR`` per (entry, pixel),
    ``OPS_PER_ENTRY_ROW`` per entry and tile row) over the instruction rate
    and the bytes K1 must move (each live record and id read once, each
    output written once) over the memory rate. With ``bin_subtile`` bands
    (dims' seventh entry) a live chunk is a band's and meets the band's
    tile_h / sub rows. Returns (ms, "operations" or "bytes", live chunks)."""
    recs, _ids, _start, nch = inputs
    n_vals, th, tw, n_ty, n_tx, c = dims[:6]
    rows = th // (dims[6] if len(dims) > 6 else 1)
    live_chunks = int(nch.sum())
    ops = live_chunks * c * rows * (tw * K1_OPS_PER_PAIR + OPS_PER_ENTRY_ROW)
    ops_ms = ops / H100_PEAK_FP32_INSTR * 1e3
    n_out = recs.shape[0] * n_ty * th * n_tx * tw
    nbytes = (live_chunks * c * (recs.shape[1] + 1) * 4 + 2 * nch.numel() * 4
              + n_out * (2 + n_vals) * 4)
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", live_chunks
    return bytes_ms, "bytes", live_chunks


def measure_kernel_mfu(frame_fn, counts, n_frames=8, logdir=None,
                       kernel_substrings=("gbuffer_tiles",)):
    """Trace ``frame_fn(i)`` for ``n_frames`` iterations on the card with
    ``torch.profiler``, take K1's exclusive device time from the Chrome
    trace (:func:`exclusive_times`) and set ``kernel_counts``' work beside
    it: K1's ms per frame, its useful and issued instructions, their shares
    of the card's fp32 instruction rate, and ``floor_ratio``, the traced
    time over the issued instructions' least time. ``frame_fn`` renders
    one frame. Returns None when the trace holds no such kernel (no card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return None
    # A fresh directory per run: a reused one could hand back an earlier
    # run's trace if this one failed to be written.
    logdir = logdir or tempfile.mkdtemp(prefix="wr_mfu_trace_")
    frame_fn(0)  # warm before the traced window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n_frames):
            frame_fn(i + 1)
        torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    ex = exclusive_times(path)
    kernel_s = sum(s for name, s in ex.items()
                   if any(k in name for k in kernel_substrings))
    if kernel_s <= 0:
        return None
    per_frame = kernel_s / n_frames
    useful, issued = kernel_flops(counts)
    return {
        "kernel_ms_per_frame": per_frame * 1e3,
        "useful_gop_per_frame": useful / 1e9,
        "issued_gop_per_frame": issued / 1e9,
        "util_useful": useful / per_frame / H100_PEAK_FP32_INSTR,
        "util_issued": issued / per_frame / H100_PEAK_FP32_INSTR,
        "floor_ratio": per_frame / (issued / H100_PEAK_FP32_INSTR),
        "trace": path,
    }
