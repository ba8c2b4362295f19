"""The PyTorch port's chunk prep and kernel K1's plain version against the
JAX package on identical inputs, and K1's tie rule, empty tiles and
wrapper.

K1's plain version is held against the JAX kernel ``gbuffer_tiles_dma``
run in interpret mode, as the JAX package's own tests run it on the CPU.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``, on the same synthetic edge cases as here."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu.ops.gbuffer  # noqa: F401  (sys.modules below)
import worldrenderer_tpu.ops.gbuffer_pallas  # noqa: F401

import worldrenderer_tpu_torch as pt
from worldrenderer_tpu_torch.ops import gbuffer as pg
from worldrenderer_tpu_torch.ops import gbuffer_cuda as pc
from worldrenderer_tpu_torch.ops import rasterize as pr

from chip_smoke import synthetic_k1_inputs, synthetic_k1_tie_inputs
from test_torch_port_raster import (
    _BIN_CASES, _FAST, _bin_args, _np, _scene, _setups, jr,
)

jg = sys.modules["worldrenderer_tpu.ops.gbuffer"]
jp = sys.modules["worldrenderer_tpu.ops.gbuffer_pallas"]


def _l_cap(cfg, t_total, n_tiles, c=128):
    k_cap = min(cfg.max_tris_per_tile or pr._auto_cap(t_total, n_tiles), t_total)
    l_keys = t_total * cfg.bin_span_tiles_y * cfg.bin_span_tiles_x
    l_keys += min(cfg.bin_huge, t_total) * n_tiles if cfg.bin_huge > 0 else 0
    if cfg.bin_med > 0:
        l_keys += (min(cfg.bin_med, t_total) * cfg.bin_med_span_y
                   * cfg.bin_med_span_x)
    if cfg.bin_flat_cap_factor > 0:
        l_keys = min(l_keys, cfg.bin_flat_cap_factor * t_total)
    l_cap = min(l_keys + n_tiles * (c - 1), n_tiles * (-(-k_cap // c) * c))
    return k_cap, -(-l_cap // c) * c


def _recs_from_jax(planes_flat, sel_flat, n_vals, c=128):
    """Map the JAX kernel's inputs entry by entry onto K1's layout:
    planes_flat (B, 4 coef, NCH*4c) per chunk [e0|e1|e2|z] and sel_flat
    (B, m_pad, NCH*c) rows [id hi, id lo, z a,b,g, (a,b,g) per value]."""
    planes_flat, sel_flat = _np(planes_flat), _np(sel_flat)
    bsz, _, l4 = planes_flat.shape
    l_cap = l4 // 4
    geo = planes_flat.reshape(bsz, 4, l_cap // c, 4, c).transpose(0, 3, 1, 2, 4)
    geo = geo.reshape(bsz, 4, 4, l_cap)[:, :, :3].reshape(bsz, 12, l_cap)
    np.testing.assert_array_equal(geo[:, 9:12], sel_flat[:, 2:5])
    recs = np.concatenate([geo, sel_flat[:, 5:5 + 3 * n_vals]], axis=1)
    ids = (sel_flat[:, 0] * 256 + sel_flat[:, 1]).astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(recs)), torch.from_numpy(ids)


def _prep_both(scene, cfg, n_attr):
    """Both packages' K1 inputs from identical clip coordinates, plus the
    port's own chunk prep and the JAX chunk tables for comparison."""
    v4, faces, verts, h, w = _scene(scene)
    t_total = faces.shape[0]
    rng = np.random.default_rng(7)
    v_attr = rng.standard_normal((verts.shape[0], n_attr)).astype(np.float32)
    a3 = v_attr[faces.T.reshape(-1)].T.reshape(n_attr, 3, t_total)
    n_ty, n_tx = -(-h // cfg.tile_h), -(-w // cfg.tile_w)
    k_cap, l_cap = _l_cap(cfg, t_total, n_ty * n_tx)
    js, ps = _setups(v4, faces, w, h, cfg.backface_cull)
    args, kw = _bin_args(cfg, w, h)
    ref = []
    for s in js:
        flat = jr._bin_flat(s, *args, **kw)
        chunk_args = (s, jnp.asarray(faces), jnp.asarray(v_attr), flat, k_cap,
                      n_tx, cfg.tile_w, cfg.tile_h, 128, l_cap)
        ref.append((jg._flat_chunks(*chunk_args, a3=jnp.asarray(a3)),
                    jg._flat_chunks(*chunk_args, a3=jnp.asarray(a3),
                                    defer=True)))
    flat = pr._bin_flat(ps, *args, **kw)
    attr_rows = pg._attr_planes_t(ps, torch.from_numpy(a3))
    table, flat_ids, chunk_tile, start_chunks, n_chunks = pg._flat_chunks(
        ps, attr_rows, flat, k_cap, 128, l_cap)
    rec = torch.gather(table, 2, flat_ids.long()[:, None].expand(
        -1, table.shape[1], -1))
    recs = pg._flat_chunks_finish(rec, chunk_tile, n_tx, cfg.tile_w,
                                  cfg.tile_h, 128)
    ours = (recs, flat_ids, chunk_tile, start_chunks, n_chunks)
    return ours, ref, (n_attr + 1, cfg.tile_h, cfg.tile_w, n_ty, n_tx)


@pytest.mark.parametrize("case", ["fast", "medium"])
def test_flat_chunks_match_jax(case):
    scene, cfg = _BIN_CASES[case]
    (recs, flat_ids, chunk_tile, start_chunks, n_chunks), ref, dims = (
        _prep_both(scene, cfg, 3))
    n_vals = dims[0]
    for i, (name, ours) in enumerate((("flat_ids", flat_ids),
                                      ("chunk_tile", chunk_tile),
                                      ("start_chunks", start_chunks),
                                      ("n_chunks", n_chunks))):
        np.testing.assert_array_equal(
            _np(ours), np.stack([_np(r[1][i + 1]) for r in ref]),
            err_msg=name)
    ref_recs, ref_ids = _recs_from_jax(
        np.stack([_np(r[0][0]) for r in ref]),
        np.stack([_np(r[0][1]) for r in ref]), n_vals)
    np.testing.assert_array_equal(_np(flat_ids), _np(ref_ids))
    np.testing.assert_allclose(_np(recs), _np(ref_recs), rtol=1e-6, atol=0)


@pytest.mark.parametrize("scene, cfg", [
    ("icosphere", pt.RasterizerConfig(bin_sort_pairs_min_tris=1)),
    ("headline", _FAST),
])
def test_gbuffer_tiles_plain_matches_jax_kernel(scene, cfg):
    """K1's plain version against the JAX kernel (interpret mode, exact
    fp32 dot) on the JAX package's own chunk lists."""
    _, ref, (n_vals, tile_h, tile_w, n_ty, n_tx) = _prep_both(scene, cfg, 6)
    planes_flat = jnp.stack([r[0][0] for r in ref])
    sel_flat = jnp.stack([r[0][1] for r in ref])
    start_chunks = jnp.stack([r[0][2] for r in ref])
    n_chunks = jnp.stack([r[0][3] for r in ref])
    jz, jid, jvals = jp.gbuffer_tiles_dma(
        planes_flat, sel_flat, start_chunks, n_chunks, n_vals, tile_h, tile_w,
        n_ty, n_tx, 128, jax.lax.Precision.HIGHEST, 1, cfg.winner_mode)
    recs, ids = _recs_from_jax(planes_flat, sel_flat, n_vals)
    z, idm, vals = pc.gbuffer_tiles_plain(
        recs, ids, torch.from_numpy(_np(start_chunks)),
        torch.from_numpy(_np(n_chunks)), n_vals, tile_h, tile_w, n_ty, n_tx,
        128)
    jz, jid, jvals = _np(jz), _np(jid).astype(np.int64), _np(jvals)
    z, idm, vals = _np(z), _np(idm).astype(np.int64), _np(vals)
    cov = np.isfinite(jz)
    assert cov.sum() > 1000
    np.testing.assert_array_equal(np.isfinite(z), cov)
    np.testing.assert_array_equal(idm, jid)
    np.testing.assert_allclose(z[cov], jz[cov], atol=1e-5)
    np.testing.assert_array_equal(vals[:, :, ~cov.any(0)], 0.0)
    den = np.where(cov[:, None], vals[:, -1:], 1.0)
    jden = np.where(cov[:, None], jvals[:, -1:], 1.0)
    covb = np.broadcast_to(cov[:, None], den.shape[:1] + (n_vals - 1,) + den.shape[2:])
    np.testing.assert_allclose((vals[:, :-1] / den)[covb],
                               (jvals[:, :-1] / jden)[covb], atol=5e-4)


def _jax_from_recs(recs, ids, n_vals, c=128):
    """K1's inputs in the JAX kernel's layout, the inverse of
    ``_recs_from_jax``: planes_flat (B, 4 coef, NCH*4c) per chunk
    [e0|e1|e2|z] with a zero fourth coefficient row, and sel_flat
    (B, m_pad, NCH*c) rows [id hi, id lo, z a,b,g, (a,b,g) per value]."""
    recs, ids = _np(recs), _np(ids).astype(np.int64)
    bsz, _, l_cap = recs.shape
    nch = l_cap // c
    geo = np.zeros((bsz, 4, 4, nch, c), np.float32)  # (B, blk, coef, NCH, c)
    geo[:, :, :3] = recs[:, :12].reshape(bsz, 4, 3, nch, c)
    planes = geo.transpose(0, 2, 3, 1, 4).reshape(bsz, 4, nch * 4 * c)
    m_sel = 5 + 3 * n_vals
    sel = np.zeros((bsz, -(-m_sel // 8) * 8, l_cap), np.float32)
    sel[:, 0], sel[:, 1] = ids // 256, ids % 256
    sel[:, 2:5] = recs[:, 9:12]
    sel[:, 5:m_sel] = recs[:, 12:]
    return jnp.asarray(planes), jnp.asarray(sel)


def test_gbuffer_tiles_plain_matches_jax_kernel_on_ties():
    """K1's plain version against the JAX kernel (interpret mode) on the
    heavy tile of exact ties across chunks: +0 then -0 then +0, -0 then +0
    then -0, and three -0.5 planes over 10 chunks. Both keep the first
    entry in list order: ids bit for bit; z and values within the
    tolerances of the scene test above (the JAX kernel evaluates the
    winner's planes as a dot, which rounds otherwise)."""
    (recs, ids, start, nch), dims, winners = synthetic_k1_tie_inputs("cpu")
    n_vals, tile_h, tile_w, n_ty, n_tx, c = dims
    planes_flat, sel_flat = _jax_from_recs(recs, ids, n_vals, c)
    ref_recs, ref_ids = _recs_from_jax(planes_flat, sel_flat, n_vals, c)
    assert torch.equal(ref_recs, recs) and torch.equal(ref_ids, ids)
    jz, jid, jvals = jp.gbuffer_tiles_dma(
        planes_flat, sel_flat, jnp.asarray(_np(start)), jnp.asarray(_np(nch)),
        n_vals, tile_h, tile_w, n_ty, n_tx, c, jax.lax.Precision.HIGHEST, 1,
        "vpu")
    z, idm, vals = pc.gbuffer_tiles_plain(recs, ids, start, nch, *dims)
    np.testing.assert_array_equal(_np(idm).astype(np.int64),
                                  _np(jid).astype(np.int64))
    np.testing.assert_array_equal(np.isfinite(_np(z)), np.isfinite(_np(jz)))
    cov = np.isfinite(_np(jz))
    np.testing.assert_allclose(_np(z)[cov], _np(jz)[cov], atol=1e-5)
    np.testing.assert_allclose(_np(vals), _np(jvals), atol=5e-4)
    tile = _np(idm)[0, :16, :128]
    assert (tile[:8, :64] == int(ids[0, winners["+0 first"]])).all()
    assert (tile[:8, 64:] == int(ids[0, winners["-0 first"]])).all()
    assert (tile[8:] == int(ids[0, winners["-0.5 first"]])).all()


def test_gbuffer_tiles_plain_tie_rule_and_empty_tiles():
    (recs, ids, start, nch), dims = synthetic_k1_inputs("cpu")
    z, idm, vals = pc.gbuffer_tiles_plain(recs, ids, start, nch, *dims)
    n_vals, th, tw, n_ty, n_tx, c = dims
    # a brute-force sequential scan, the kernel's own formulation
    lx = torch.arange(tw, dtype=torch.float32) + 0.5
    ly = torch.arange(th, dtype=torch.float32) + 0.5
    for b, ty, tx in ((0, 0, 0), (0, 1, 0), (1, 1, 1)):
        t = ty * n_tx + tx
        e0 = int(start[b, t]) * c
        e1 = e0 + int(nch[b, t]) * c
        zb = torch.full((th, tw), float("inf"))
        wb = torch.full((th, tw), -1, dtype=torch.long)
        for e in range(e0, e1):
            r = recs[b, :, e]
            ev = [r[3 * k] * lx[None] + r[3 * k + 1] * ly[:, None] + r[3 * k + 2]
                  for k in range(4)]
            cov = (ev[0] >= 0) & (ev[1] >= 0) & (ev[2] >= 0) & (ev[3] >= -1) & (
                ev[3] <= 1)
            upd = cov & (ev[3] < zb)
            zb = torch.where(upd, ev[3], zb)
            wb = torch.where(upd, e, wb)
        sl = (b, slice(ty * th, ty * th + th), slice(tx * tw, tx * tw + tw))
        want_id = torch.where(wb >= 0, ids[b][wb.clamp(min=0)], pc.BACKGROUND_ID)
        assert torch.equal(idm[sl], want_id)
        assert torch.equal(z[sl], zb)
        assert (wb >= 0).any()
    assert torch.isinf(z[0, :16, 128:]).all()  # empty tiles
    assert (idm[1, :16, :128] == pc.BACKGROUND_ID).all()
    assert (vals[1, :, :16, :128] == 0).all()
    # ties within and across chunks: the first entry wins the whole tile
    tile = (1, slice(0, 16), slice(128, 256))
    assert (idm[tile] == int(ids[1, 0])).all()
    assert (z[tile] == -0.9).all()


def test_kernel_wrapper_takes_plain_version_on_cpu():
    (recs, ids, start, nch), dims = synthetic_k1_inputs("cpu")
    before = pc.launch_count
    got = pc.gbuffer_tiles(recs, ids, start, nch, *dims)
    want = pc.gbuffer_tiles_plain(recs, ids, start, nch, *dims)
    assert pc.launch_count == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        pc.gbuffer_tiles(recs.double(), ids, start, nch, *dims)
    with pytest.raises(ValueError):
        pc.gbuffer_tiles(recs[:, :-3].contiguous(), ids, start, nch, *dims)
