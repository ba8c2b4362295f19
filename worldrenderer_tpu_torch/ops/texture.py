"""UV texture sampling, the nvdiffrast ``texture`` (PyTorch counterpart of
``worldrenderer_tpu/ops/texture.py``).

Convention: uv in [0, 1]^2, texel (ix, iy) centred at ((ix+0.5)/W,
(iy+0.5)/H), texture row 0 at v ~= 0 (as nvdiffrast).

Bilinear sampling reads one row of a QUAD TABLE per pixel: row (y, x) holds
the texel's 2x2 neighbourhood [t(y,x), t(y,x+1), t(y+1,x), t(y+1,x+1)]
under the boundary mode, so the four taps are one gather. Mip levels are
flattened into one table with per-level row offsets. Every step is a plain
PyTorch op with the JAX package's expression order, so the port's CPU and
card runs give the same bits (no texture kernel: the gathers are PyTorch's
until an H100 measurement calls for one).

The JAX package's ``gather_mode`` names (vmap, flat1d, block8, shard4) and
``filter_mode="linear_block8"`` are TPU gather-emitter layouts with outputs
bit-identical to ``linear``; the port accepts them and runs one gather.
``pack_mode="u8"`` rounds texels to k/255 and gathers quad rows of
byte-packed words (12 RGB taps in 3 words instead of 12 fp32 columns),
unpacked to ``byte / 255``: exact for k/255 textures.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device, to_int32_sat
from ..utils.debug import annotate, count

__all__ = ["texture", "texture_construct_mip"]

_GATHER_MODES = ("vmap", "flat1d", "block8", "shard4")
_PACK_MODES = ("none", "u8")


def _boundary(idx: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    """Texel index under the boundary mode. ``wrap`` is a floor mod
    (``jnp.mod``), so negative indices wrap."""
    if mode == "wrap":
        return torch.remainder(idx, size)
    if mode in ("clamp", "zero"):
        return torch.clamp(idx, 0, size - 1)
    raise ValueError(f"unknown boundary_mode {mode!r}")


def _quad_table(tex: torch.Tensor, boundary_mode: str) -> torch.Tensor:
    """(B, TH, TW, C) -> (B, QH, QW, 4C), row (y, x) holding the taps
    [t(y,x), t(y,x+1), t(y+1,x), t(y+1,x+1)].

    wrap: rolled copies, gather index mod(x0, tw). clamp / zero: the texture
    edge- or zero-padded by one texel on each side, gather index
    clip(x0 + 1, 0, tw)."""
    if boundary_mode == "wrap":
        tx = torch.roll(tex, -1, dims=2)
        ty = torch.roll(tex, -1, dims=1)
        txy = torch.roll(tx, -1, dims=1)
        return torch.cat([tex, tx, ty, txy], dim=-1)
    if boundary_mode == "clamp":
        p = torch.cat([tex[:, :1], tex, tex[:, -1:]], dim=1)
        p = torch.cat([p[:, :, :1], p, p[:, :, -1:]], dim=2)
    elif boundary_mode == "zero":
        b, th, tw, c = tex.shape
        p = tex.new_zeros((b, th + 2, tw + 2, c))
        p[:, 1:-1, 1:-1] = tex
    else:
        raise ValueError(f"unknown boundary_mode {boundary_mode!r}")
    return torch.cat(
        [p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1], p[:, 1:, 1:]], dim=-1
    )


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """255-quantize to uint8: round half to even, then clip, so
    ``byte / 255`` reconstructs k/255 texels bit for bit."""
    return torch.clamp(torch.round(x.float() * 255.0), 0.0, 255.0).to(torch.uint8)


def _pack_u8_words(quad_u8: torch.Tensor) -> torch.Tensor:
    """(B, QH, QW, K) uint8 -> (B, QH*QW, ceil(K/4)) int32 words, the bits
    of the JAX package's uint32 words (little-endian byte order within each
    word): the packed quad rows of ``pack_mode="u8"``, four taps per word."""
    b, qh, qw, k = quad_u8.shape
    kw = -(-k // 4)
    if k % 4:
        pad = quad_u8.new_zeros((b, qh, qw, kw * 4 - k))
        quad_u8 = torch.cat([quad_u8, pad], dim=-1)
    w = quad_u8.reshape(b, qh * qw, kw, 4).to(torch.int64)
    words = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _byte_values_np() -> np.ndarray:
    """byte / 255 for every byte, IEEE-divided in fp32 on the host (a card
    divides a tensor by a scalar as a multiply by its reciprocal, which can
    miss the correctly rounded quotient by one bit)."""
    return np.arange(256, dtype=np.float32) / np.float32(255.0)


def _unpack_u8_words(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`_pack_u8_words` on gathered rows: (..., KW) int32
    -> (..., K) float32 in [0, 1] (texel = byte / 255). The arithmetic
    shift's sign bits fall to the byte mask."""
    count("host_sync.u8_unpack", 2)  # two copies from the host
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int32, device=words.device)
    bytes_ = (words[..., None] >> shifts) & 0xFF
    flat = bytes_.reshape(*words.shape[:-1], words.shape[-1] * 4)[..., :k]
    return torch.from_numpy(_byte_values_np()).to(words.device)[flat.long()]


def _blend_taps(taps, fx, fy, c_ch, zero_masks=None):
    """The four taps of a quad row blended with bilinear weights, in the
    JAX package's expression order. ``zero_masks`` (in_x0, in_x1, in_y0,
    in_y1): per-tap validity for the ``zero`` boundary mode."""
    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = fx * (1.0 - fy)
    w10 = (1.0 - fx) * fy
    w11 = fx * fy
    if zero_masks is not None:
        in_x0, in_x1, in_y0, in_y1 = zero_masks
        w00 = w00 * (in_x0 & in_y0)
        w01 = w01 * (in_x1 & in_y0)
        w10 = w10 * (in_x0 & in_y1)
        w11 = w11 * (in_x1 & in_y1)
    return (
        taps[..., 0 * c_ch:1 * c_ch] * w00
        + taps[..., 1 * c_ch:2 * c_ch] * w01
        + taps[..., 2 * c_ch:3 * c_ch] * w10
        + taps[..., 3 * c_ch:4 * c_ch] * w11
    )


def _gather_rows(table: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Rows ``flat`` (B, H, W) of ``table`` (B, R, cols), or of a shared
    (1, R, cols) table: (B, H, W, cols) in the table's dtype."""
    idx = flat.long()
    if table.shape[0] == 1:
        return table[0][idx]
    off = torch.arange(flat.shape[0], device=flat.device)[:, None, None]
    return table.reshape(-1, table.shape[2])[idx + off * table.shape[1]]


def _quad_rows(tex: torch.Tensor, boundary_mode: str, pack_mode: str):
    """The quad table of ``tex`` as rows (B, QH*QW, cols) and its (QH, QW):
    4C columns in the texture's dtype, or for ``pack_mode="u8"`` the
    texels 255-quantized and packed into ceil(4C/4) int32 words."""
    if pack_mode == "u8":
        quad = _quad_table(_quantize_u8(tex), boundary_mode)
        return _pack_u8_words(quad), quad.shape[1:3]
    quad = _quad_table(tex, boundary_mode)
    return quad.reshape(quad.shape[0], -1, quad.shape[3]), quad.shape[1:3]


def _taps(rows: torch.Tensor, pack_mode: str, c_ch: int) -> torch.Tensor:
    """Gathered quad rows as float32 taps (B, H, W, 4C)."""
    if pack_mode == "u8":
        return _unpack_u8_words(rows, 4 * c_ch)
    return rows.float()


def _check_batch(tex_b: int, b: int) -> None:
    if tex_b != 1 and tex_b != b:
        raise ValueError(f"texture batch {tex_b} must be 1 or the uv batch {b}")


def _zero_masks(x0, y0, tw, th):
    return (
        ((x0 >= 0) & (x0 < tw))[..., None],
        ((x0 + 1 >= 0) & (x0 + 1 < tw))[..., None],
        ((y0 >= 0) & (y0 < th))[..., None],
        ((y0 + 1 >= 0) & (y0 + 1 < th))[..., None],
    )


# --- cube-map sampling ---------------------------------------------------
# OpenGL cube-map convention (face order +x,-x,+y,-y,+z,-z; per-face (sc, tc)
# axes as in the GL spec table), as nvdiffrast's boundary_mode='cube'.


def _cube_face_dirs(face, sc, tc):
    """Per-face direction vector for in-face coords (numpy, vectorized)."""
    one = np.ones_like(sc)
    table = [
        (one, -tc, -sc),      # +x
        (-one, -tc, sc),      # -x
        (sc, one, tc),        # +y
        (sc, -one, -tc),      # -y
        (sc, -tc, one),       # +z
        (-sc, -tc, -one),     # -z
    ]
    out = np.empty(sc.shape + (3,), np.float64)
    for f in range(6):
        m = face == f
        for a in range(3):
            out[..., a][m] = table[f][a][m]
    return out


def _cube_lookup_np(d):
    """direction -> (face, u, v) in numpy (for the static border maps)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    face = np.where(
        is_x, np.where(x >= 0, 0, 1),
        np.where(is_y, np.where(y >= 0, 2, 3), np.where(z >= 0, 4, 5)),
    )
    ma = np.where(is_x, ax, np.where(is_y, ay, az))
    sc = np.select([face == 0, face == 1, face == 5], [-z, z, -x], default=x)
    tc = np.select([face == 2, face == 3], [z, -z], default=-y)
    return face, 0.5 * (sc / ma + 1.0), 0.5 * (tc / ma + 1.0)


def _cube_lookup(d: torch.Tensor):
    """direction (..., 3) -> (face int32, u, v), per pixel."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    face = torch.where(
        is_x, torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)),
    ).to(torch.int32)
    ma = torch.maximum(torch.maximum(ax, ay), az)
    inv = 1.0 / torch.clamp(ma, min=1e-30)
    sc = torch.where(face == 0, -z,
                     torch.where(face == 1, z, torch.where(face == 5, -x, x)))
    tc = torch.where(face == 2, z, torch.where(face == 3, -z, -y))
    return face, 0.5 * (sc * inv + 1.0), 0.5 * (tc * inv + 1.0)


@functools.lru_cache(maxsize=8)
def _cube_border_maps(size: int):
    """Static source-texel maps for the one-texel seamless border: every
    border cell of every padded face takes the nearest texel of the face
    its texel centre's direction resolves onto. Returns (dst_face, dst_row,
    dst_col, src_face, src_iy, src_ix) int64 numpy arrays."""
    s = size
    rr, cc = np.meshgrid(np.arange(s + 2), np.arange(s + 2), indexing="ij")
    border = (rr == 0) | (rr == s + 1) | (cc == 0) | (cc == s + 1)
    r_b, c_b = rr[border], cc[border]
    dst_face = np.repeat(np.arange(6), r_b.size)
    r_all = np.tile(r_b, 6)
    c_all = np.tile(c_b, 6)
    sc = ((c_all - 1) + 0.5) / s * 2.0 - 1.0
    tc = ((r_all - 1) + 0.5) / s * 2.0 - 1.0
    d = _cube_face_dirs(dst_face, sc, tc)
    src_face, u, v = _cube_lookup_np(d)
    src_ix = np.clip(np.floor(u * s), 0, s - 1).astype(np.int64)
    src_iy = np.clip(np.floor(v * s), 0, s - 1).astype(np.int64)
    return (dst_face.astype(np.int64), r_all.astype(np.int64),
            c_all.astype(np.int64), src_face.astype(np.int64), src_iy, src_ix)


def _cube_padded(tex: torch.Tensor) -> torch.Tensor:
    """(B, 6, S, S, C) -> (B, 6, S+2, S+2, C) with seamless borders. The
    border cells are distinct, so the indexed write is deterministic on
    every device."""
    b, _, s, _, c = tex.shape
    count("host_sync.cube_borders", 6)  # six copies from the host
    df, dr, dc, sf, sy, sx = (torch.from_numpy(a).to(tex.device)
                              for a in _cube_border_maps(s))
    padded = tex.new_zeros((b, 6, s + 2, s + 2, c))
    padded[:, :, 1:-1, 1:-1] = tex
    padded[:, df, dr, dc, :] = tex[:, sf, sy, sx, :]
    return padded


def _texture_cube(tex: torch.Tensor, uv: torch.Tensor, filter_mode: str):
    """Cube sampling: tex (B, 6, S, S, C), uv = directions (B, H, W, 3)."""
    if tex.ndim != 5 or tex.shape[1] != 6 or tex.shape[2] != tex.shape[3]:
        raise ValueError("cube sampling needs tex (B, 6, S, S, C) with square "
                         f"faces, got {tuple(tex.shape)}")
    if uv.shape[-1] != 3:
        raise ValueError(f"cube sampling needs 3-D directions, got {tuple(uv.shape)}")
    if filter_mode not in ("nearest", "linear"):
        raise NotImplementedError(
            f"cube filter_mode {filter_mode!r} not supported (no cube mip)")
    _check_batch(tex.shape[0], uv.shape[0])
    s, c_ch = tex.shape[2], tex.shape[4]
    face, u, v = _cube_lookup(uv)

    if filter_mode == "nearest":
        ix = torch.clamp(to_int32_sat(torch.floor(u * s)), 0, s - 1)
        iy = torch.clamp(to_int32_sat(torch.floor(v * s)), 0, s - 1)
        flat = (face * s + iy) * s + ix
        return _gather_rows(tex.reshape(tex.shape[0], 6 * s * s, c_ch),
                            flat).float()

    x = u * s - 0.5
    y = v * s - 0.5
    x0 = to_int32_sat(torch.floor(x))
    y0 = to_int32_sat(torch.floor(y))
    fx = (x - x0.float())[..., None]
    fy = (y - y0.float())[..., None]
    padded = _cube_padded(tex)
    quad = _quad_table(padded.reshape(tex.shape[0] * 6, s + 2, s + 2, c_ch),
                       "clamp")  # (B*6, S+3, S+3, 4C)
    q = s + 3
    table = quad.reshape(tex.shape[0], 6 * q * q, 4 * c_ch)
    # The 2x2 window at seamless-padded coord x0 + 1 is quad row x0 + 2.
    ix = torch.clamp(x0 + 2, 1, s + 1)
    iy = torch.clamp(y0 + 2, 1, s + 1)
    flat = (face * q + iy) * q + ix
    return _blend_taps(_gather_rows(table, flat).float(), fx, fy, c_ch)


def _as_texture(tex) -> torch.Tensor:
    """bf16 stays bf16 (tables at half the memory, taps lerped in fp32);
    every other dtype becomes float32."""
    tex = torch.as_tensor(tex)
    return tex if tex.dtype == torch.bfloat16 else tex.float()


def texture_construct_mip(
    tex: torch.Tensor, max_mip_level: Optional[int] = None,
    device: DeviceLike = None,
) -> List[torch.Tensor]:
    """Mipmap stack for :func:`texture` on ``device`` (the card unless
    ``device="cpu"``; ``tex`` is moved there), base level NOT included: 2x2
    box-filtered levels until a dimension turns odd (or ``max_mip_level``
    levels)."""
    t = _as_texture(tex).to(resolve_device(device))
    levels = []
    th, tw = t.shape[1], t.shape[2]
    while (th % 2 == 0 and tw % 2 == 0 and th >= 2 and tw >= 2
           and (max_mip_level is None or len(levels) < max_mip_level)):
        t = 0.25 * (t[:, 0::2, 0::2] + t[:, 0::2, 1::2]
                    + t[:, 1::2, 0::2] + t[:, 1::2, 1::2])
        th //= 2
        tw //= 2
        levels.append(t)
    return levels


def texture(
    tex: torch.Tensor,
    uv: torch.Tensor,
    uv_da: Optional[torch.Tensor] = None,
    mip_level_bias: Optional[torch.Tensor] = None,
    mip: Optional[Sequence[torch.Tensor]] = None,
    filter_mode: str = "linear",
    boundary_mode: str = "wrap",
    max_mip_level: Optional[int] = None,
    gather_mode: str = "vmap",
    pack_mode: str = "none",
    device: DeviceLike = None,
) -> torch.Tensor:
    """Sample a 2D texture on ``device`` (the card unless ``device="cpu"``;
    the inputs are moved there).

    tex (B, TH, TW, C) or (1, TH, TW, C) (shared by every view); for
    ``boundary_mode="cube"`` (B, 6, S, S, C). uv (B, H, W, 2); for cube
    mode (B, H, W, 3) directions. uv_da (B, H, W, 4): image-space uv
    derivatives (du/dX, du/dY, dv/dX, dv/dY), mip_level_bias (B, H, W):
    the mip level terms. mip: a prebuilt :func:`texture_construct_mip`
    stack. filter_mode: auto | nearest | linear | linear_block8 |
    linear-mipmap-nearest | linear-mipmap-linear (auto = trilinear when
    uv_da or mip_level_bias is given, else linear). Returns (B, H, W, C)
    float32. A bfloat16 ``tex`` keeps its tables in bf16."""
    if gather_mode not in _GATHER_MODES:
        raise ValueError(f"unknown gather_mode {gather_mode!r}")
    if pack_mode not in _PACK_MODES:
        raise ValueError(f"unknown pack_mode {pack_mode!r}")
    with annotate("wr::texture"):
        return _texture(tex, uv, uv_da, mip_level_bias, mip, filter_mode,
                        boundary_mode, max_mip_level, pack_mode,
                        resolve_device(device))


def _texture(tex, uv, uv_da, mip_level_bias, mip, filter_mode, boundary_mode,
             max_mip_level, pack_mode, dev):
    uv = torch.as_tensor(uv, dtype=torch.float32, device=dev)
    tex = _as_texture(tex).to(dev)
    if filter_mode == "auto":
        filter_mode = ("linear-mipmap-linear"
                       if (uv_da is not None or mip_level_bias is not None)
                       else "linear")
    if boundary_mode == "cube":
        return _texture_cube(tex, uv, filter_mode)
    if filter_mode in ("linear-mipmap-nearest", "linear-mipmap-linear"):
        return _texture_mip(tex, uv, uv_da, mip_level_bias, mip, filter_mode,
                            boundary_mode, max_mip_level, pack_mode)
    _check_batch(tex.shape[0], uv.shape[0])
    th, tw, c_ch = tex.shape[1], tex.shape[2], tex.shape[3]
    x = uv[..., 0] * tw - 0.5
    y = uv[..., 1] * th - 0.5

    if filter_mode == "nearest":
        # Nearest taps are exact texels: u8 packing changes nothing.
        ix = to_int32_sat(torch.floor(x + 0.5))
        iy = to_int32_sat(torch.floor(y + 0.5))
        flat = _boundary(iy, th, boundary_mode) * tw + _boundary(ix, tw, boundary_mode)
        out = _gather_rows(tex.reshape(tex.shape[0], th * tw, c_ch), flat).float()
        if boundary_mode == "zero":
            in_range = (ix >= 0) & (ix < tw) & (iy >= 0) & (iy < th)
            out = torch.where(in_range[..., None], out, 0.0)
        return out

    if filter_mode not in ("linear", "linear_block8"):
        raise NotImplementedError(f"filter_mode {filter_mode!r} not supported")
    x0 = to_int32_sat(torch.floor(x))
    y0 = to_int32_sat(torch.floor(y))
    fx = (x - x0.float())[..., None]
    fy = (y - y0.float())[..., None]
    table, (qh, qw) = _quad_rows(tex, boundary_mode, pack_mode)
    if boundary_mode == "wrap":
        ix, iy = torch.remainder(x0, tw), torch.remainder(y0, th)
    else:
        ix, iy = torch.clamp(x0 + 1, 0, tw), torch.clamp(y0 + 1, 0, th)
    taps = _taps(_gather_rows(table, iy * qw + ix), pack_mode, c_ch)
    zero_masks = _zero_masks(x0, y0, tw, th) if boundary_mode == "zero" else None
    return _blend_taps(taps, fx, fy, c_ch, zero_masks)


def _texture_mip(tex, uv, uv_da, mip_level_bias, mip, filter_mode,
                 boundary_mode, max_mip_level, pack_mode="none"):
    """Mip-mapped sampling: every level's quad table flattened into ONE row
    table with per-level offsets. The level is nvdiffrast's, 0.5 * log2 of
    the larger footprint axis in texel^2 units, plus the bias."""
    _check_batch(tex.shape[0], uv.shape[0])
    dev = uv.device
    th, tw, c_ch = tex.shape[1], tex.shape[2], tex.shape[3]
    levels = [tex] + [
        _as_texture(m).to(dev) for m in
        (mip if mip is not None
         else texture_construct_mip(tex, max_mip_level, device=dev))
    ]
    n_lvl = len(levels)
    # pack_mode="u8": an 8-bit mip chain, every level re-quantized to 255ths.
    tables, offs, tws, ths, qws = [], [], [], [], []
    at = 0
    for lv in levels:
        rows, (qh_l, qw_l) = _quad_rows(lv, boundary_mode, pack_mode)
        tables.append(rows)
        offs.append(at)
        tws.append(lv.shape[2])
        ths.append(lv.shape[1])
        qws.append(qw_l)
        at += qh_l * qw_l
    table = torch.cat(tables, dim=1)

    def ints(v):
        count("host_sync.mip_levels")  # a copy from the host
        return torch.tensor(v, dtype=torch.int32, device=dev)

    offs_i, tws_i, ths_i, qws_i = ints(offs), ints(tws), ints(ths), ints(qws)
    tws_f, ths_f = tws_i.float(), ths_i.float()

    if uv_da is not None:
        uv_da = torch.as_tensor(uv_da, dtype=torch.float32, device=dev)
        dx2 = (uv_da[..., 0] * tw) ** 2 + (uv_da[..., 2] * th) ** 2
        dy2 = (uv_da[..., 1] * tw) ** 2 + (uv_da[..., 3] * th) ** 2
        foot = torch.clamp(torch.maximum(dx2, dy2), min=1e-20)
        lvl = 0.5 * torch.log2(foot)
        if mip_level_bias is not None:
            lvl = lvl + torch.as_tensor(mip_level_bias, dtype=torch.float32,
                                        device=dev)
    elif mip_level_bias is not None:
        lvl = torch.as_tensor(mip_level_bias, dtype=torch.float32,
                              device=dev).expand(uv.shape[:-1])
    else:
        raise ValueError("mip-mapped filter modes need uv_da and/or mip_level_bias")
    lvl = torch.clamp(lvl, 0.0, float(n_lvl - 1))

    def sample_level(li):  # (B, H, W) int32 level index per pixel
        li = li.long()
        x = uv[..., 0] * tws_f[li] - 0.5
        y = uv[..., 1] * ths_f[li] - 0.5
        x0 = to_int32_sat(torch.floor(x))
        y0 = to_int32_sat(torch.floor(y))
        fx = (x - x0.float())[..., None]
        fy = (y - y0.float())[..., None]
        twi, thi = tws_i[li], ths_i[li]
        if boundary_mode == "wrap":
            ix, iy = torch.remainder(x0, twi), torch.remainder(y0, thi)
        else:
            ix = torch.minimum(torch.clamp(x0 + 1, min=0), twi)
            iy = torch.minimum(torch.clamp(y0 + 1, min=0), thi)
        taps = _taps(_gather_rows(table, offs_i[li] + iy * qws_i[li] + ix),
                     pack_mode, c_ch)
        zero_masks = (_zero_masks(x0, y0, twi, thi)
                      if boundary_mode == "zero" else None)
        return _blend_taps(taps, fx, fy, c_ch, zero_masks)

    if filter_mode == "linear-mipmap-nearest":
        return sample_level(to_int32_sat(torch.round(lvl)))
    l0 = to_int32_sat(torch.floor(lvl))
    l1 = torch.clamp(l0 + 1, max=n_lvl - 1)
    f = (lvl - l0.float())[..., None]
    return sample_level(l0) * (1.0 - f) + sample_level(l1) * f
