"""Loop-level CPU models of how kernels K1-K4 compute, held against their
plain versions bit for bit.

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
    which reached the least z in an earlier chunk keeps that entry;
  * K2 (``zattr_kernel``) and K4 (``csrc/raster_zid_tiles.cu``): the same
    split over blocks, a thread's pixels in one column (``part_pixel_col``)
    so each plane's a * lx is computed once per entry and column, a strict
    scan in list order, and for K2 the exact ties settled at each chunk's
    end: the least id among that chunk's entries at the least z, only where
    the best was set in that chunk.
The K3 model also runs with a wrong guard, and the K2 model with wrong tie
rules, to show that the tie cases tell the right rule from the wrong
ones."""

import functools

import numpy as np
import pytest
import torch

from worldrenderer_tpu_torch.ops import gbuffer_cuda as gc
from worldrenderer_tpu_torch.ops import raster_zid_cuda as rk
from worldrenderer_tpu_torch.ops import zattr_cuda as zc
from worldrenderer_tpu_torch.ops.tensor import pad_tile_blocks, plane_dot, plane_vpu
from worldrenderer_tpu_torch.transforms import fma_f32

from chip_smoke import (
    slot_tie_tile_inputs,
    synthetic_k1_inputs,
    synthetic_k1_tie_inputs,
    synthetic_tile_inputs,
    zero_sign_tile_inputs,
    zid_tile_inputs,
)

THREADS = 256  # tile_scan::kThreads
MAX_GROUPS = 8  # tile_scan::kMaxGroups


@pytest.fixture
def one_torch_thread():
    """Torch on one thread for a test: beside other test processes on the
    same cores, the intra-op threads of the K2 and K4 models' plane
    evaluations would wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split_tile(groups, n, cap=MAX_GROUPS):
    """tile_scan::split_tile: (pixel groups per part, parts)."""
    work = max(n, 1)
    ng = 1
    while ng * 2 <= cap and ng * 2 * work <= groups:
        ng *= 2
    return ng, -(-groups // ng)


def group_cap(n_tiles, groups, resident):
    """tile_scan::group_cap: the largest cap on a part's groups (8, 4, 2,
    1) at which the tiles at one chunk each make two waves of the resident
    blocks."""
    cap = MAX_GROUPS
    while cap > 1 and n_tiles * split_tile(groups, 1, cap)[1] < 2 * resident:
        cap //= 2
    return cap


def part_pixels(p0, ng, tile_w):
    """tile_scan::part_pixel for every (thread, q) of a part, (THREADS, ng):
    with a power-of-two tile width a thread's pixels share a row."""
    t = np.arange(THREADS)[:, None]
    q = np.arange(ng)[None]
    if tile_w >= MAX_GROUPS and tile_w & (tile_w - 1) == 0:
        step = min(tile_w // ng, THREADS)
        return p0 + (t // step) * tile_w + t % step + q * step
    return p0 + q * THREADS + t


def part_pixels_col(p0, ng):
    """tile_scan::part_pixel_col for every (thread, q) of a part,
    (THREADS, ng): pixel p0 + q * THREADS + t."""
    return p0 + np.arange(ng)[None] * THREADS + np.arange(THREADS)[:, None]


def column_mapping(tile_w):
    """tile_scan::column_mapping: a thread's pixels share a column."""
    return THREADS % tile_w == 0


@pytest.mark.parametrize("tile_h, tile_w", [(16, 128), (32, 128), (64, 128),
                                            (8, 32), (4, 8), (16, 96), (8, 512)])
def test_part_pixels_col_cover_each_pixel_once_and_share_columns(tile_h, tile_w):
    """Over the parts of any split, every pixel of the tile is one thread's
    exactly once; where the width divides the block's 256 threads a
    thread's pixels share a column, and a warp's 32 threads sit on 32
    neighbouring pixels of one row (of whole rows when the tile is
    narrower), so its stores stay coalesced."""
    p_tile = tile_h * tile_w
    groups = -(-p_tile // THREADS)
    for n in (0, 1, 2, 3, 5, 9, 40):
        ng, parts = split_tile(groups, n)
        pix = np.stack([part_pixels_col(j * ng * THREADS, ng)
                        for j in range(parts)])  # (parts, THREADS, ng)
        inside = pix[pix < p_tile]
        assert np.array_equal(np.sort(inside), np.arange(p_tile))
        warps = pix.reshape(parts, THREADS // 32, 32, ng)
        assert (np.diff(warps, axis=2) == 1).all()
        if column_mapping(tile_w):
            cols = pix % tile_w
            assert (cols == cols[..., :1]).all()
            if tile_w >= 32:
                rows = warps // tile_w
                assert (rows == rows[:, :, :1]).all()


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


@pytest.mark.parametrize("cap", [8, 4, 2, 1])
@pytest.mark.parametrize("groups", [1, 2, 5, 8, 12, 16])
def test_split_tile_bounds_each_parts_work(groups, cap):
    """Every group is some part's, a part's work ng * n stays within
    max(groups, n) (cap * n past cap groups), a tile of many chunks takes
    every group as a part of its own, and no tile needs more parts than a
    full list's split, which sizes the grid."""
    full = split_tile(groups, 40, cap)[1]
    for n in range(0, 41):
        ng, parts = split_tile(groups, n, cap)
        assert ng in (1, 2, 4, 8) and ng <= cap
        assert (parts - 1) * ng < groups <= parts * ng
        assert ng * max(n, 1) <= max(groups, max(n, 1))
        assert parts <= full
        if n >= groups:
            assert (ng, parts) == (1, groups)


@pytest.mark.parametrize("n_tiles, groups, resident, cap", [
    (384, 16, 528, 4),    # workload 1 on an H100: 132 SMs, 4 blocks each
    (384, 16, 396, 4),    # the same at 3 blocks per SM
    (1024, 16, 528, 8),   # the 2048^2 atlas
    (4, 8, 528, 1),       # a few tiles: every group a block
    (10000, 2, 528, 8)])  # many small tiles
def test_group_cap_fills_two_waves_or_splits_to_single_groups(
        n_tiles, groups, resident, cap):
    """The cap is the largest at which the tiles, at one chunk each, make
    two waves of resident blocks; where none does, a part takes one group."""
    assert group_cap(n_tiles, groups, resident) == cap
    blocks = n_tiles * split_tile(groups, 1, cap)[1]
    assert blocks >= 2 * resident or cap == 1
    if cap < MAX_GROUPS:
        assert n_tiles * split_tile(groups, 1, 2 * cap)[1] < 2 * resident


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


@functools.lru_cache(maxsize=None)
def _k3_model_on(name, guard="exact", zero_sign="min"):
    """``k3_model`` on a named case, once for every test that reads it."""
    co, counts, dims, _ = _k3_case(name)
    return k3_model(co, counts, *dims, guard=guard, zero_sign=zero_sign)


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
    got = _k3_model_on(name)
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
    got = _k3_model_on("zero_signs", zero_sign="taken")
    assert _z_signs(got[0]) == [[False], [False], [False], [False]]
    assert _z_signs(_k3_model_on("zero_signs")[0]) == [
        [True], [True], [False], [True]]


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


# ---- K2 and K4 ----------------------------------------------------------------

K_ZCAP = np.nextafter(np.float32(1), np.float32(2))  # tile_scan::kZCap


def _dot_tile_planes(co, t, chunk, c, tile_h, tile_w):
    """e0, e1, e2 and z of the chunk's c entries at every pixel of tile t,
    each (c, P) f32 numpy, as K2 and K4 evaluate them: fma(b, ly, ax) + g,
    plane_dot's operations, with the a-term ax = a * lx computed once per
    entry and tile column (a thread whose pixels share a column computes
    it once; at other widths each pixel's product is the same value)."""
    pix = torch.arange(tile_h * tile_w)
    ly = ((pix // tile_w).float() + 0.5).double()
    lx_col = torch.arange(tile_w).float() + 0.5
    e = slice(chunk * c, (chunk + 1) * c)
    out = []
    for blk in range(4):
        a, b, g = (co[t, i, blk, e, None] for i in range(3))  # (c, 1)
        ax = (a * lx_col)[:, pix % tile_w]
        out.append((fma_f32(b.double(), ly, ax.double()) + g).numpy())
    return out


def dot_model(coeffs, counts, r, tile_h, tile_w, chunk, ties=None,
              cap=MAX_GROUPS, planes=None):
    """K2's (``ties`` given) or K4's (``ties`` None) CUDA algorithm, block
    by block: grid max_parts * n_tiles (the split of a full list of K
    entries at ``cap`` groups a part), each part's pixels by
    ``part_pixel_col``; per pixel a scan in list order from (zbest kZCap,
    win -1) that makes only strict improvements and raises its thread's tie
    flag on an equal z. A chunk's scan runs at once over its entries: the
    best z before entry j is the running minimum of the covered z before
    it, so entry j improves where its z lies below that, and the winner is
    the last entry that improved. K2's tie pass at a chunk's end, on the
    threads whose flag is up: ``ties`` is "chunk" (the kernel's rule: where
    the best was set in this chunk, the covered entry of the chunk after
    the winner at zbest with the least id replaces the winner if that id is
    smaller), "first" (no tie pass: the first entry in list order) or
    "across" (the chunk's ties also replace a best of an earlier chunk).
    ``planes`` caches each (tile, chunk)'s planes at every pixel of the
    tile, for the calls on one case's geometry. Returns per tile (zbest + 0,
    +inf on background; win, -1 on background), asserting that every pixel
    is written exactly once."""
    co, nch_t, c = pad_tile_blocks(coeffs, r, counts, chunk)
    n_tiles = co.shape[0]
    p_tile = tile_h * tile_w
    groups = -(-p_tile // THREADS)
    z_out = np.full((n_tiles, p_tile), np.nan, np.float32)
    w_out = np.full((n_tiles, p_tile), -2, np.int64)
    written = np.zeros((n_tiles, p_tile), np.int64)
    planes = {} if planes is None else planes
    max_parts = split_tile(groups, co.shape[3] // c, cap)[1]
    j_col = np.arange(c)[:, None]
    for block in range(max_parts * n_tiles):
        t, part = block % n_tiles, max_parts - 1 - block // n_tiles
        nch = int(nch_t[t])
        ng, parts = split_tile(groups, nch, cap)
        if part >= parts:
            continue
        ids = co[t, 2, 4].numpy() if ties else None
        # The part's pixels, group by group (part_pixels_col's, transposed):
        # one run of the tile's pixels, so the planes are read as a slice.
        pix = part_pixels_col(part * ng * THREADS, ng).T.reshape(-1)
        thread = np.tile(np.arange(THREADS), ng)
        keep = pix < p_tile
        pix, thread = pix[keep], thread[keep]
        run_px = slice(int(pix[0]), int(pix[-1]) + 1)
        assert (np.diff(pix) == 1).all()
        zbest = np.full(pix.shape, K_ZCAP, np.float32)
        win = np.full(pix.shape, -1, np.int64)
        for ci in range(nch):
            if (t, ci) not in planes:
                planes[t, ci] = _dot_tile_planes(co, t, ci, c, tile_h, tile_w)
            e0, e1, e2, z = (p[:, run_px] for p in planes[t, ci])
            cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z >= -1)
            e_base = ci * c
            # The hot loop: the best z before each entry, in list order.
            zc = np.where(cov, z, np.float32(np.inf))
            run = np.minimum.accumulate(np.vstack([zbest[None], zc]), axis=0)
            before = run[:-1]
            upd = zc < before
            tie_px = (cov & (z == before)).any(axis=0)
            last = c - 1 - np.argmax(upd[::-1], axis=0)
            win = np.where(upd.any(axis=0), e_base + last, win)
            zbest = run[-1]
            if ties in (None, "first"):
                continue
            flag = np.zeros(THREADS, bool)
            flag[thread[tie_px]] = True
            own = win >= e_base if ties == "chunk" else win >= 0
            todo = flag[thread] & own
            if not todo.any():
                continue
            # The tie pass: the chunk's covered entries after the winner at
            # zbest, the least id among them if it is below the winner's.
            idw = ids[np.maximum(win, 0)]
            cand = ((j_col > win - e_base) & cov & (z == zbest) & (z <= 1))
            idc = np.where(cand, ids[e_base:e_base + c, None], np.inf)
            take = todo & (idc.min(axis=0) < idw)
            win = np.where(take, e_base + idc.argmin(axis=0), win)
        z_out[t, pix] = np.where(win >= 0, zbest + np.float32(0), np.inf)
        w_out[t, pix] = win
        written[t, pix] += 1
    assert (written == 1).all()
    return torch.from_numpy(z_out), torch.from_numpy(w_out)


def k2_model(coeffs, counts, n_vals, tile_h, tile_w, chunk, ties="chunk",
             cap=MAX_GROUPS, planes=None):
    """K2's z, ids and values from ``dot_model``'s winners: the id plane's
    value and the winner's value planes (plane_dot, plus +0)."""
    r = 5 + n_vals
    z, win = dot_model(coeffs, counts, r, tile_h, tile_w, chunk, ties, cap,
                       planes)
    co = pad_tile_blocks(coeffs, r, counts, chunk)[0]
    n_tiles = co.shape[0]
    hit = win >= 0
    w = win.clamp(min=0)
    rows = torch.arange(n_tiles)[:, None]
    idv = torch.where(hit, co[rows, 2, 4, w], zc.BACKGROUND_ID)
    pix = torch.arange(tile_h * tile_w)
    lx, ly = (pix % tile_w).float() + 0.5, (pix // tile_w).float() + 0.5
    vals = torch.stack([plane_dot(co[rows, 0, 5 + v, w], co[rows, 1, 5 + v, w],
                                  co[rows, 2, 5 + v, w], lx, ly) + 0.0
                        for v in range(n_vals)], 1)
    vals = torch.where(hit[:, None], vals, 0.0)
    shape = (n_tiles, tile_h, tile_w)
    return z.reshape(shape), idv.reshape(shape), \
        vals.reshape(n_tiles, n_vals, tile_h, tile_w)


@functools.lru_cache(maxsize=None)
def _dot_case(name):
    """A named K2 case from the K3 cases: (coeffs, counts, dims), K4's
    geometry blocks and counts, and a cache of the planes that the K2 and
    K4 models of the case share at every cap."""
    co, counts, dims, _ = _k3_case(name)
    co4, _, counts4 = zid_tile_inputs(co, counts, dims[0])
    return co, counts, dims, co4, counts4, {}


@functools.lru_cache(maxsize=None)
def _dot_plain(kernel, name):
    """K2's (``zattr_tiles``) or K4's (``raster_zid_tiles``) plain version
    on a named case, once for every test that holds a model to it."""
    co, counts, dims, co4, counts4, _ = _dot_case(name)
    if kernel == "zattr_tiles":
        return zc.zattr_tiles_plain(co, counts, *dims)
    return rk.raster_zid_tiles_plain(co4, counts4, *dims[1:])


DOT_CASES = ["synthetic", "synthetic_w96", "synthetic_c256", "synthetic_64x128",
             "slot_ties", "slot_ties_c256", "zero_signs"]


def _assert_bits(got, want):
    for what, a, b in zip(("z", "id", "vals"), got, want):
        assert torch.equal(a, b), what
        if a.is_floating_point():
            assert torch.equal(torch.signbit(a), torch.signbit(b)), what


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("name", DOT_CASES)
def test_k2_model_matches_plain_version(name):
    """The column-mapped strict scan with the chunk-end tie pass gives K2's
    plain version's z (its sign included), ids and values bit for bit, at
    c = 128 and 256, tile widths 128 and 96 (no column mapping) and 64x128
    tiles."""
    co, counts, dims, _, _, planes = _dot_case(name)
    got = k2_model(co, counts, *dims, planes=planes)
    _assert_bits(got, _dot_plain("zattr_tiles", name))
    if name == "zero_signs":
        assert (got[0] == 0).all() and not torch.signbit(got[0]).any()


def k4_model(co4, counts4, tile_h, tile_w, chunk, cap=MAX_GROUPS, planes=None):
    """K4's z and slots (``BACKGROUND_SLOT`` on background) from
    ``dot_model``'s scan without a tie pass."""
    z, win = dot_model(co4, counts4, 4, tile_h, tile_w, chunk, cap=cap,
                       planes=planes)
    shape = (co4.shape[0], tile_h, tile_w)
    slot = torch.where(win >= 0, win, rk.BACKGROUND_SLOT).to(torch.int32)
    return z.reshape(shape), slot.reshape(shape)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("name", DOT_CASES)
def test_k4_model_matches_plain_version(name):
    """The same scan without a tie pass gives K4's plain version's z (its
    sign included) and slots bit for bit on the same blocks' geometry."""
    _, _, dims, co4, counts4, planes = _dot_case(name)
    _assert_bits(k4_model(co4, counts4, *dims[1:], planes=planes),
                 _dot_plain("raster_zid_tiles", name))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("cap", [4, 2, 1])
@pytest.mark.parametrize("name", ["synthetic", "synthetic_64x128"])
def test_k2_k4_models_match_plain_versions_at_every_cap(name, cap):
    """The kernels choose a part's groups from the grid's size (group_cap):
    at every cap the split changes which block scans a pixel, never the
    pixel's scan, so K2 and K4 keep their plain versions' bits."""
    co, counts, dims, co4, counts4, planes = _dot_case(name)
    _assert_bits(k2_model(co, counts, *dims, cap=cap, planes=planes),
                 _dot_plain("zattr_tiles", name))
    _assert_bits(k4_model(co4, counts4, *dims[1:], cap=cap, planes=planes),
                 _dot_plain("raster_zid_tiles", name))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("ties", ["first", "across"])
def test_k2_synthetic_case_rejects_a_wrong_tie_rule(ties):
    """Keeping the first entry at the least z (no tie pass) takes entry 5
    of the synthetic case's tile 2, and settling ties across chunks takes
    entry 130 (the least id over all chunks); K2's rule, the least id of
    the first chunk that reaches the least z, takes entry 9."""
    co, counts, dims, _, _, planes = _dot_case("synthetic")
    want = _dot_plain("zattr_tiles", "synthetic")
    got = k2_model(co, counts, *dims, ties=ties, planes=planes)
    assert not torch.equal(got[1][2], want[1][2])
    ids = co.reshape(4, 3, 7, -1)[:, 2, 4]
    entry = {"first": 5, "across": 130}[ties]
    assert (got[1][2] == ids[2, entry]).all()
    assert (want[1][2] == ids[2, 9]).all()


@pytest.mark.parametrize("kernel", ["zattr_tiles", "zattr_tiles_vpu",
                                    "raster_zid_tiles"])
def test_plain_versions_with_every_count_0_give_the_background(kernel):
    """With every count 0 no tile scans a chunk (``chip_smoke.py`` times the
    kernels so, to read what their grids cost without the scan): each plain
    version returns the background, z +inf, ids (K4's slots) 2^30 and
    values 0."""
    co, _, _, counts = synthetic_tile_inputs("cpu")
    zero = torch.zeros_like(counts)
    if kernel == "raster_zid_tiles":
        co4, _, _ = zid_tile_inputs(co, counts, 2)
        z, slot = rk.raster_zid_tiles_plain(co4, zero, 16, 128, 128)
        assert (slot == rk.BACKGROUND_SLOT).all()
    else:
        z, idv, vals = getattr(zc, f"{kernel}_plain")(co, zero, 2, 16, 128, 128)
        assert (idv == zc.BACKGROUND_ID).all() and (vals == 0).all()
    assert z.shape == (4, 16, 128) and torch.isinf(z).all() and (z > 0).all()
