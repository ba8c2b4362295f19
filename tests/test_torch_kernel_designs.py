"""Loop-level CPU models of how kernels K1 and K3 compute, held against
their unchanged plain versions bit for bit.

The CUDA kernels cannot run here; these models follow their algorithms
step by step so the decomposition and the tie rules can be checked on the
CPU, on the synthetic edge cases ``chip_smoke.py`` holds the kernels to on
the card:
  * K1 (``csrc/gbuffer_tiles.cu``): the grid of (part, tile) blocks per
    view, each tile's run clamped and split into parts by ``split_tile``,
    each part a sequential strict-``<`` scan of the whole run over its own
    pixel groups;
  * K3 (``csrc/zattr_tiles.cu`` ``zattr_vpu_kernel``): one scan per pixel
    in list order whose exact-tie rule reproduces K3's per-lane-slot
    running buffers and cross-slot reduction, with the guard that a slot
    which reached the least z in an earlier chunk keeps that entry.
The K3 model also runs with a wrong guard, to show that the same-slot tie
case tells the right rule from the wrong ones."""

import numpy as np
import pytest
import torch

from worldrenderer_tpu_torch.ops import gbuffer_cuda as gc
from worldrenderer_tpu_torch.ops import zattr_cuda as zc
from worldrenderer_tpu_torch.ops.tensor import pad_tile_blocks, plane_vpu

from chip_smoke import (
    slot_tie_tile_inputs,
    synthetic_k1_inputs,
    synthetic_k1_tie_inputs,
    synthetic_tile_inputs,
    zero_sign_tile_inputs,
)

THREADS = 256  # tile_scan::kThreads
MAX_GROUPS = 8  # tile_scan::kMaxGroups


def split_tile(groups, n):
    """tile_scan::split_tile: (pixel groups per part, parts)."""
    work = max(n, 1)
    ng = 1
    while ng * 2 <= MAX_GROUPS and ng * 2 * work <= groups:
        ng *= 2
    return ng, -(-groups // ng)


def part_pixels(p0, ng, tile_w):
    """tile_scan::part_pixel for every (thread, q) of a part, (THREADS, ng):
    with a power-of-two tile width a thread's pixels share a row."""
    t = np.arange(THREADS)[:, None]
    q = np.arange(ng)[None]
    if tile_w >= MAX_GROUPS and tile_w & (tile_w - 1) == 0:
        step = min(tile_w // ng, THREADS)
        return p0 + (t // step) * tile_w + t % step + q * step
    return p0 + q * THREADS + t


@pytest.mark.parametrize("tile_h, tile_w", [(16, 128), (32, 128), (8, 512),
                                            (1, 4096), (4, 8), (16, 24)])
def test_part_pixels_cover_each_pixel_once_and_share_rows(tile_h, tile_w):
    """Over the parts of any split, every pixel of the tile is one thread's
    exactly once; with a power-of-two width a thread's pixels share a row."""
    p_tile = tile_h * tile_w
    groups = -(-p_tile // THREADS)
    for n in (0, 1, 2, 3, 5, 9, 40):
        ng, parts = split_tile(groups, n)
        pix = np.stack([part_pixels(j * ng * THREADS, ng, tile_w)
                        for j in range(parts)])
        inside = pix[pix < p_tile]
        assert np.array_equal(np.sort(inside), np.arange(p_tile))
        if tile_w & (tile_w - 1) == 0 and tile_w >= MAX_GROUPS:
            rows = pix // tile_w
            assert (rows == rows[..., :1]).all()


@pytest.mark.parametrize("groups", [1, 2, 5, 8, 12, 16])
def test_split_tile_bounds_each_parts_work(groups):
    """Every group is some part's, a part's work ng * n stays within
    max(groups, n) (kMaxGroups * n past 8 groups), and a tile of many
    chunks takes every group as a part of its own."""
    for n in range(0, 41):
        ng, parts = split_tile(groups, n)
        assert ng in (1, 2, 4, 8) and ng <= MAX_GROUPS
        assert (parts - 1) * ng < groups <= parts * ng
        assert ng * max(n, 1) <= max(groups, max(n, 1))
        if n >= groups:
            assert (ng, parts) == (1, groups)


# ---- K1 ---------------------------------------------------------------------

def k1_model(recs, ids, start_chunks, n_chunks, n_vals, tile_h, tile_w, n_ty,
             n_tx, c):
    """K1's CUDA algorithm, block by block: grid (groups * n_tiles, B),
    block x = (groups - 1 - part) * n_tiles + tile; asserts that every pixel
    is written exactly once."""
    recs, ids = recs.numpy(), ids.numpy()
    start_chunks, n_chunks = start_chunks.numpy(), n_chunks.numpy()
    bsz, _, l_cap = recs.shape
    n_tiles = n_ty * n_tx
    p_tile = tile_h * tile_w
    groups = -(-p_tile // THREADS)
    ph, pw = n_ty * tile_h, n_tx * tile_w
    z = np.full((bsz, ph, pw), np.nan, np.float32)
    idm = np.full((bsz, ph, pw), -1, np.int64)
    vals = np.full((bsz, n_vals, ph, pw), np.nan, np.float32)
    written = np.zeros((bsz, ph, pw), np.int64)

    def plane(co, lx, ly):  # tile_scan::plane_sep
        return (co[0] * lx + co[1] * ly) + co[2]

    for b in range(bsz):
        for block in range(groups * n_tiles):
            tile, part = block % n_tiles, groups - 1 - block // n_tiles
            nch_total = l_cap // c
            base = min(max(int(start_chunks[b, tile]), 0), nch_total)
            nch = min(max(int(n_chunks[b, tile]), 0), nch_total - base)
            ng, parts = split_tile(groups, nch)
            if part >= parts:
                continue
            pix = part_pixels(part * ng * THREADS, ng, tile_w).reshape(-1)
            pix = pix[pix < p_tile]
            lx = (pix % tile_w).astype(np.float32) + np.float32(0.5)
            ly = (pix // tile_w).astype(np.float32) + np.float32(0.5)
            # zbest starts just above 1 (kZCap): "z < zbest" tests z <= 1
            zbest = np.full(pix.shape, np.nextafter(np.float32(1), np.float32(2)))
            win = np.full(pix.shape, -1, np.int64)
            for e in range(base * c, (base + nch) * c):  # list order
                r = recs[b, :, e]
                zz = plane(r[9:12], lx, ly)
                cov = ((plane(r[0:3], lx, ly) >= 0) & (plane(r[3:6], lx, ly) >= 0)
                       & (plane(r[6:9], lx, ly) >= 0) & (zz >= -1))
                upd = cov & (zz < zbest)
                zbest = np.where(upd, zz, zbest)
                win = np.where(upd, e, win)
            y = (tile // n_tx) * tile_h + pix // tile_w
            x = (tile % n_tx) * tile_w + pix % tile_w
            hit = win >= 0
            w = np.maximum(win, 0)
            z[b, y, x] = np.where(hit, zbest, np.inf)
            idm[b, y, x] = np.where(hit, ids[b, w], gc.BACKGROUND_ID)
            for v in range(n_vals):
                co = recs[b, 12 + 3 * v:15 + 3 * v][:, w]
                vals[b, v, y, x] = np.where(hit, plane(co, lx, ly), 0.0)
            written[b, y, x] += 1
    assert (written == 1).all()
    return torch.from_numpy(z), torch.from_numpy(idm.astype(np.int32)), \
        torch.from_numpy(vals)


def _k1_case(name):
    if name.startswith("synthetic"):
        inputs, dims = synthetic_k1_inputs("cpu")
        if name.endswith("w96"):  # no power of two: a pixel per group
            dims = dims[:2] + (96,) + dims[3:]
        return inputs, dims
    inputs, dims, _ = synthetic_k1_tie_inputs("cpu")
    return inputs, dims


@pytest.mark.parametrize("name", ["synthetic", "synthetic_w96", "ties"])
def test_k1_model_matches_plain_version(name):
    """The pixel-split scan gives the plain version's z, ids and values bit
    for bit: on the 33-chunk tile (8 parts of one group), the 5-chunk tile,
    empty tiles, and the heavy tile of exact +0 / -0 / -0.5 ties."""
    inputs, dims = _k1_case(name)
    got = k1_model(*inputs, *dims)
    want = gc.gbuffer_tiles_plain(*inputs, *dims)
    for what, a, b in zip(("z", "id", "vals"), got, want):
        assert torch.equal(a, b), what
        assert torch.equal(torch.signbit(a.float()), torch.signbit(b.float())), what


def test_k1_ties_keep_the_first_entry_in_list_order():
    """+0 then -0 then +0 keeps the first +0, -0 then +0 then -0 the first
    -0 (signed zeros compare equal), three -0.5 planes the first in list
    order — in the plain version, which the kernel is held to."""
    (recs, ids, start, nch), dims, winners = synthetic_k1_tie_inputs("cpu")
    z, idm, _ = gc.gbuffer_tiles_plain(recs, ids, start, nch, *dims)
    top_left, top_right, low = (slice(0, 8), slice(0, 64)), \
        (slice(0, 8), slice(64, 128)), (slice(8, 16), slice(0, 128))
    for region, name, sign in ((top_left, "+0 first", False),
                               (top_right, "-0 first", True),
                               (low, "-0.5 first", True)):
        assert (idm[0][region] == ids[0, winners[name]]).all(), name
        assert (torch.signbit(z[0][region]) == sign).all(), name


# ---- K3 ---------------------------------------------------------------------

def k3_model(coeffs, counts, n_vals, tile_h, tile_w, chunk, guard="exact",
             zero_sign="min"):
    """K3's CUDA algorithm, block by block (grid max_parts * n_tiles, the
    split of a full list of K entries): one scan per pixel in (chunk, slot)
    order with state (zbest from 1, win); the strict improvements in
    the hot loop, an exact tie of a covered entry then decided by the slot
    rule. ``guard`` is the test such a tie must also pass to replace:
    "exact" (the entry's slot did not reach zbest in an earlier chunk, the
    kernel's rule), "none" (no test) or "any_earlier" (the slot had no
    covered entry in an earlier chunk). ``zero_sign`` is the sign zbest
    keeps at a tie of -0 and +0: "min" (-0 once a tie that passes the
    guard is -0, the TPU kernel's cross-slot jnp.min and the kernel's rule)
    or "taken" (the sign of the entry that replaces the winner)."""
    co, nch_t, c = pad_tile_blocks(coeffs, 5 + n_vals, counts, chunk)
    n_tiles = co.shape[0]
    p_tile = tile_h * tile_w
    groups = -(-p_tile // THREADS)
    z_out = torch.full((n_tiles, p_tile), float("nan"))
    id_out = torch.full((n_tiles, p_tile), float("nan"))
    v_out = torch.full((n_tiles, n_vals, p_tile), float("nan"))
    written = torch.zeros((n_tiles, p_tile), dtype=torch.long)

    def plane(e, blk, lx, ly):
        return plane_vpu(co[t, 0, blk, e], co[t, 1, blk, e], co[t, 2, blk, e],
                         lx, ly)

    def covered_z(e, lx, ly):
        z = plane(e, 3, lx, ly)
        cov = ((plane(e, 0, lx, ly) >= 0) & (plane(e, 1, lx, ly) >= 0)
               & (plane(e, 2, lx, ly) >= 0) & (z >= -1) & (z <= 1))
        return z, cov

    max_parts = split_tile(groups, co.shape[3] // c)[1]  # a full list's
    for block in range(max_parts * n_tiles):
        t, part = block % n_tiles, max_parts - 1 - block // n_tiles
        nch = int(nch_t[t])
        ng, parts = split_tile(groups, nch)
        if part >= parts:
            continue
        pix = torch.from_numpy(part_pixels(part * ng * THREADS, ng, tile_w)
                               .reshape(-1))
        pix = pix[pix < p_tile]
        lx = (pix % tile_w).float() + 0.5
        ly = (pix // tile_w).float() + 0.5
        zbest = torch.full(pix.shape, 1.0)
        win = torch.full(pix.shape, -1, dtype=torch.long)
        for ci in range(nch):
            for s in range(c):
                e = ci * c + s
                z, cov = covered_z(e, lx, ly)
                upd = cov & (z < zbest)  # the hot loop
                tie = cov & (z == zbest)
                if bool(tie.any()):  # the tie pass
                    idv = co[t, 2, 4, e]
                    idw = co[t, 2, 4, win.clamp(min=0)]
                    better = (win < 0) | (idv < idw) | ((idv == idw) & (s < win % c))
                    reached = torch.zeros_like(tie)
                    if guard != "none":
                        for cj in range(ci):  # slot s's earlier entries
                            ze, cove = covered_z(cj * c + s, lx, ly)
                            reached |= cove & (ze == z) if guard == "exact" else cove
                    take = tie & better & ~reached
                    win = torch.where(take, e, win)
                    if zero_sign == "min":
                        zbest = torch.where(tie & ~reached & torch.signbit(z),
                                            z, zbest)
                    else:
                        zbest = torch.where(take, z, zbest)
                zbest = torch.where(upd, z, zbest)
                win = torch.where(upd, e, win)
        hit = win >= 0
        w = win.clamp(min=0)
        vals = plane_vpu(co[t, 0, 5:][:, w], co[t, 1, 5:][:, w],
                         co[t, 2, 5:][:, w], lx, ly) + 0.0
        z_out[t, pix] = torch.where(hit, zbest, float("inf"))
        id_out[t, pix] = torch.where(hit, co[t, 2, 4, w], zc.BACKGROUND_ID)
        v_out[t][:, pix] = torch.where(hit, vals, 0.0)
        written[t, pix] += 1
    assert (written == 1).all()
    return (z_out.reshape(n_tiles, tile_h, tile_w),
            id_out.reshape(n_tiles, tile_h, tile_w),
            v_out.reshape(n_tiles, n_vals, tile_h, tile_w))


def _k3_case(name):
    """(coeffs, counts, dims, winners or None) of a named case."""
    if name.startswith("synthetic"):
        co, _, _, counts = synthetic_tile_inputs("cpu")
        c = 256 if name.endswith("c256") else 128
        th, tw = {"w96": (16, 96), "64x128": (64, 128)}.get(
            name.split("_")[-1], (16, 128))
        return co, counts, (2, th, tw, c), None
    if name == "zero_signs":
        (co, counts), winners, _ = zero_sign_tile_inputs("cpu")
        return co, counts, (2, 16, 128, 128), winners
    c = 256 if name.endswith("c256") else 128
    (co, counts), winners = slot_tie_tile_inputs("cpu", c)
    return co, counts, (2, 16, 128, c), winners


def _z_signs(z):
    """Per tile, the sign bits of its z (one bool if they agree)."""
    return [sorted({bool(b) for b in torch.signbit(t).flatten().tolist()})
            for t in z]


@pytest.mark.parametrize("name", ["synthetic", "synthetic_w96", "synthetic_c256",
                                  "synthetic_64x128", "slot_ties",
                                  "slot_ties_c256", "zero_signs"])
def test_k3_model_matches_plain_version(name):
    """The per-pixel scan with the slot guard gives the slot buffers' and
    cross-slot reduction's z, ids and values bit for bit, at c = 128 and
    256. At -0 / +0 ties across slots (zero_signs) the plain version's
    torch.amin leaves z's sign to its reduction order; there the values
    agree and z's sign is the TPU kernel's jnp.min's, -0 in every tile
    with a slot at -0."""
    co, counts, dims, winners = _k3_case(name)
    got = k3_model(co, counts, *dims)
    want = zc.zattr_tiles_vpu_plain(co, counts, *dims)
    for what, a, b in zip(("z", "id", "vals"), got, want):
        assert torch.equal(a, b), what
        if what != "z" or name != "zero_signs":
            assert torch.equal(torch.signbit(a), torch.signbit(b)), what
    if name == "zero_signs":
        signs = zero_sign_tile_inputs("cpu")[2]
        assert _z_signs(got[0]) == [[s] for s in signs]
    if winners is not None:
        k = co.shape[2] // 7
        ids = co.reshape(4, 3, 7, k)[:, 2, 4]
        for t, e in enumerate(winners["zattr_tiles_vpu"]):
            assert (got[1][t] == ids[t, e]).all(), t


def test_k3_zero_sign_case_rejects_the_taken_sign():
    """Keeping the sign of the entry that replaces the winner, the rule of
    an earlier version of the kernel, gives +0 in three tiles where the
    TPU kernel's jnp.min gives -0 (a +0 entry wins by id or first place
    while another slot holds -0); the zero-sign case shows it."""
    co, counts, dims, _ = _k3_case("zero_signs")
    got = k3_model(co, counts, *dims, zero_sign="taken")
    assert _z_signs(got[0]) == [[False], [False], [False], [False]]
    assert _z_signs(k3_model(co, counts, *dims)[0]) == [[True], [True], [False],
                                                        [True]]


@pytest.mark.parametrize("guard", ["none", "any_earlier"])
def test_k3_slot_tie_case_rejects_a_wrong_guard(guard):
    """Without the guard K3 would take a later entry of a slot that already
    holds the least z (tiles 0, 2, 3); with a guard that blocks any slot
    with an earlier covered entry it would miss a slot that reaches the
    least z only later (tile 1). The same-slot tie case shows both."""
    co, counts, dims, _ = _k3_case("slot_ties")
    got = k3_model(co, counts, *dims, guard=guard)
    want = zc.zattr_tiles_vpu_plain(co, counts, *dims)
    differ = [bool((got[1][t] != want[1][t]).any()) for t in range(4)]
    if guard == "none":
        assert differ[0] and differ[2] and differ[3]
    else:
        assert differ[1]
