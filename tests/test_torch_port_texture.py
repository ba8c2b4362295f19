"""The port's texture sampling and silhouette antialiasing against the JAX
package's: the quad table, the u8 pack, ``texture`` over filter, boundary
and pack modes with shared and per-view textures, every gather mode name,
bf16 tables, the mip chain and both mip filters, the cube map, and
``antialias`` analytic and in its screen-space fallback. Inputs are made
with numpy from a seed and handed to both packages.

The reference runs two ways. Op by op (``jax.disable_jit``) it evaluates
the same fp32 expressions as the port: discrete results (``nearest``, the
``round`` of ``linear-mipmap-nearest``'s level) must be equal and
continuous ones agree within 1e-6 (``torch.log2`` and XLA's may differ by
an ulp, which moves trilinear's level fraction). Jitted, XLA contracts
``u * tw - 0.5`` and the bilinear blend into FMAs: continuous results
still agree within 1e-6, but a ``floor`` at a texel boundary may flip, so
discrete results are held to a flip budget of 1e-3 of the pixels. At a NaN
uv the jitted ``zero`` mode turns the multiply of a NaN weight by a false
mask into a select and returns 0 where op by op (and the port) return NaN,
so pixels the op-by-op reference leaves NaN are held only against it.
Antialiasing is held exactly against the op-by-op reference (its
crossings and weights are the same fp32 expressions) and within 1e-4 of
the jitted one, whose contracted FMAs move the edge values, at a flip
budget of 1e-3 of the pixels."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worldrenderer_tpu as wr
import worldrenderer_tpu.ops.antialias  # noqa: F401  (sys.modules below)
import worldrenderer_tpu.ops.texture  # noqa: F401
from worldrenderer_tpu.mesh import uv_sphere_mesh
from worldrenderer_tpu.transforms import get_clip_space_position as j_clip

import worldrenderer_tpu_torch as pt
import worldrenderer_tpu_torch.ops.texture  # noqa: F401

ja = sys.modules["worldrenderer_tpu.ops.antialias"]
jt = sys.modules["worldrenderer_tpu.ops.texture"]
ptx = sys.modules["worldrenderer_tpu_torch.ops.texture"]

ATOL = 1e-6
FLIP_BUDGET = 1e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def inp():
    """Shared (1, 16, 24, 3) and per-view (2, 16, 24, 3) textures, uv over
    [-0.3, 1.3) (every boundary runs) with a NaN, mip footprints, biases,
    a 32² texture for the mips, cube faces and directions."""
    rng = np.random.default_rng(7)
    uv = (rng.random((2, 32, 32, 2)) * 1.6 - 0.3).astype(np.float32)
    uv[0, 0, 0, 0] = np.nan
    return dict(
        tex1=rng.random((1, 16, 24, 3)).astype(np.float32),
        texb=rng.random((2, 16, 24, 3)).astype(np.float32),
        uv=uv,
        tex32=rng.random((1, 32, 32, 3)).astype(np.float32),
        uv16=(rng.random((2, 16, 16, 2)) * 1.6 - 0.3).astype(np.float32),
        uv_da=(rng.standard_normal((2, 16, 16, 4)) * 0.05).astype(np.float32),
        bias=(rng.standard_normal((2, 16, 16)) * 1.5).astype(np.float32),
        cube=rng.random((2, 6, 8, 8, 3)).astype(np.float32),
        dirs=rng.standard_normal((2, 16, 16, 3)).astype(np.float32),
    )


def _jax_both(fn, *args):
    """The reference jitted and op by op, as numpy."""
    jitted = np.asarray(jax.jit(fn)(*args))
    with jax.disable_jit():
        eager = np.asarray(fn(*args))
    return jitted, eager


def _hold(port, jitted, eager, discrete):
    """With a discrete choice inside, the port equals the op-by-op reference
    and parts from the jitted one by more than ATOL at no more than
    FLIP_BUDGET of the pixels; without, it agrees with both within ATOL.
    NaNs must sit where the op-by-op reference has them."""
    port = _np(port)
    nan = np.isnan(eager)
    if discrete:
        np.testing.assert_array_equal(port, eager)
    else:
        np.testing.assert_allclose(port, eager, rtol=0, atol=ATOL)
    far = np.any(np.abs(port - jitted) > ATOL, axis=-1) & ~np.any(nan, axis=-1)
    assert far.mean() <= (FLIP_BUDGET if discrete else 0.0), far.mean()


@pytest.mark.parametrize("mode", ["wrap", "clamp", "zero"])
def test_quad_table_matches_jax(inp, mode):
    want = np.asarray(jt._quad_table(jnp.asarray(inp["texb"]), mode))
    np.testing.assert_array_equal(_np(ptx._quad_table(_t(inp["texb"]), mode)), want)


def test_u8_quantize_pack_unpack_match_jax(inp):
    tex = inp["texb"].copy()
    tex[0, 0, 0] = [-0.2, 1.3, 0.5 / 255]  # clipped both ways; a rounding tie
    q_j = np.asarray(jt._quantize_u8(jnp.asarray(tex)))
    q_p = ptx._quantize_u8(_t(tex))
    np.testing.assert_array_equal(_np(q_p), q_j)
    for mode in ("wrap", "zero"):
        quad_j = jt._quad_table(jnp.asarray(q_j), mode)
        words_j = np.asarray(jt._pack_u8_words(quad_j))
        words_p = ptx._pack_u8_words(ptx._quad_table(q_p, mode))
        np.testing.assert_array_equal(_np(words_p).view(np.uint32), words_j)
        np.testing.assert_array_equal(
            _np(ptx._unpack_u8_words(words_p, 12)),
            np.asarray(jt._unpack_u8_words(jnp.asarray(words_j), 12)))


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_view"])
@pytest.mark.parametrize("pack", ["none", "u8"])
@pytest.mark.parametrize("boundary", ["wrap", "clamp", "zero"])
@pytest.mark.parametrize("filt", ["nearest", "linear", "linear_block8"])
def test_texture_matches_jax(inp, filt, boundary, pack, shared):
    tex = inp["tex1"] if shared else inp["texb"]
    kw = dict(filter_mode=filt, boundary_mode=boundary, pack_mode=pack)
    jitted, eager = _jax_both(lambda a, b: jt.texture(a, b, **kw), tex, inp["uv"])
    port = ptx.texture(_t(tex), _t(inp["uv"]), **kw, device="cpu")
    assert port.dtype == torch.float32 and port.shape == (2, 32, 32, 3)
    _hold(port, jitted, eager, discrete=filt == "nearest")


@pytest.mark.parametrize("gather", ["vmap", "flat1d", "block8", "shard4"])
def test_gather_modes_match_jax(inp, gather):
    """Every gather mode name, each the JAX package's own lowering, gives
    the port's one gather's result."""
    kw = dict(filter_mode="linear", boundary_mode="clamp", gather_mode=gather)
    jitted, eager = _jax_both(lambda a, b: jt.texture(a, b, **kw), inp["texb"],
                              inp["uv"])
    _hold(ptx.texture(_t(inp["texb"]), _t(inp["uv"]), **kw, device="cpu"),
          jitted, eager, False)


@pytest.mark.parametrize("filt", ["nearest", "linear"])
def test_bf16_texture_matches_jax(inp, filt):
    tex_bf = jnp.asarray(inp["tex1"], jnp.bfloat16)
    jitted, eager = _jax_both(lambda a, b: jt.texture(a, b, filter_mode=filt),
                              tex_bf, inp["uv"])
    tex_p = _t(np.asarray(tex_bf.astype(jnp.float32))).to(torch.bfloat16)
    assert ptx._quad_table(tex_p, "wrap").dtype == torch.bfloat16
    _hold(ptx.texture(tex_p, _t(inp["uv"]), filter_mode=filt, device="cpu"),
          jitted, eager,
          discrete=filt == "nearest")


def test_u8_on_an_unquantized_texture_matches_jax(inp):
    """u8 rounds texels to k/255 first: on a texture that is not k/255 it
    differs from none, and equals the JAX package's u8."""
    kw = dict(filter_mode="linear", boundary_mode="wrap", pack_mode="u8")
    jitted, eager = _jax_both(lambda a, b: jt.texture(a, b, **kw), inp["tex1"],
                              inp["uv"])
    port = ptx.texture(_t(inp["tex1"]), _t(inp["uv"]), **kw, device="cpu")
    _hold(port, jitted, eager, discrete=False)
    none = ptx.texture(_t(inp["tex1"]), _t(inp["uv"]), filter_mode="linear",
                       device="cpu")
    assert np.nanmax(np.abs(_np(port) - _np(none))) > 1e-3


@pytest.mark.parametrize("max_level", [None, 2])
def test_mip_chain_matches_jax(inp, max_level):
    want = jt.texture_construct_mip(jnp.asarray(inp["tex32"]), max_level)
    got = ptx.texture_construct_mip(_t(inp["tex32"]), max_level, device="cpu")
    assert len(got) == len(want) == (5 if max_level is None else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("pack", ["none", "u8"])
@pytest.mark.parametrize("terms", ["uv_da", "bias", "uv_da+bias", "prebuilt_mip"])
@pytest.mark.parametrize("filt", ["linear-mipmap-nearest", "linear-mipmap-linear"])
def test_mip_filters_match_jax(inp, filt, terms, pack):
    names = {"uv_da": ("uv_da",), "bias": ("bias",),
             "uv_da+bias": ("uv_da", "bias"), "prebuilt_mip": ("uv_da",)}[terms]
    extra = [inp[n] for n in names]
    boundary = "zero" if terms == "bias" else "wrap"
    prebuilt = terms == "prebuilt_mip"

    def kwargs(vals, mk):
        kw = dict(filter_mode=filt, boundary_mode=boundary, pack_mode=pack)
        kw.update({"uv_da" if n == "uv_da" else "mip_level_bias": v
                   for n, v in zip(names, vals)})
        if prebuilt:
            kw["mip"] = mk(inp["tex32"])
        return kw

    jitted, eager = _jax_both(
        lambda a, b, *v: jt.texture(a, b, **kwargs(
            v, lambda t: jt.texture_construct_mip(jnp.asarray(t), 3))),
        inp["tex32"], inp["uv16"], *extra)
    port = ptx.texture(_t(inp["tex32"]), _t(inp["uv16"]), **kwargs(
        [_t(v) for v in extra],
        lambda t: ptx.texture_construct_mip(_t(t), 3, device="cpu")), device="cpu")
    # mipmap-nearest picks a level by round(): a discrete choice.
    _hold(port, jitted, eager, discrete=filt == "linear-mipmap-nearest")


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_view"])
@pytest.mark.parametrize("filt", ["nearest", "linear"])
def test_cube_map_matches_jax(inp, filt, shared):
    cube = inp["cube"][:1] if shared else inp["cube"]
    kw = dict(filter_mode=filt, boundary_mode="cube")
    jitted, eager = _jax_both(lambda a, b: jt.texture(a, b, **kw), cube, inp["dirs"])
    _hold(ptx.texture(_t(cube), _t(inp["dirs"]), **kw, device="cpu"), jitted, eager,
          discrete=filt == "nearest")


def test_cube_border_maps_match_jax():
    for got, want in zip(ptx._cube_border_maps(5), jt._cube_border_maps(5)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filt", ["nearest", "linear"])
def test_saturating_casts_match_xla(filt):
    """uv far out of range, infinite or NaN: the floor's int32 cast
    saturates and maps NaN to 0, as XLA's does (not as ``.to(int32)``)."""
    rng = np.random.default_rng(3)
    tex = rng.random((1, 8, 8, 2)).astype(np.float32)
    uv = np.array([[[[1e10, 0.5], [-1e10, 0.5], [np.inf, 0.2], [-np.inf, 0.7],
                     [np.nan, 0.3], [0.5, 3e9]]]], np.float32)
    for boundary in ("wrap", "clamp", "zero"):
        kw = dict(filter_mode=filt, boundary_mode=boundary)
        with jax.disable_jit():
            want = np.asarray(jt.texture(tex, uv, **kw))
        np.testing.assert_array_equal(
            _np(ptx.texture(_t(tex), _t(uv), **kw, device="cpu")), want)


def test_texture_rejects_unknown_modes(inp):
    tex, uv = _t(inp["tex1"]), _t(inp["uv"])
    for kw in (dict(gather_mode="rows"), dict(pack_mode="u4"),
               dict(boundary_mode="mirror"), dict(filter_mode="cubic")):
        with pytest.raises((ValueError, NotImplementedError)):
            ptx.texture(tex, uv, **kw, device="cpu")
    with pytest.raises(ValueError):
        ptx.texture(_t(np.zeros((3, 4, 4, 3), np.float32)), uv, device="cpu")


@functools.lru_cache(maxsize=None)
def _aa_inputs():
    """A rasterized 960-triangle sphere (2 views at 64²; the port's
    ``rasterize``, which ``test_torch_port_classic.py`` holds equal to the
    reference's), its clip positions, faces and random colours, as
    numpy."""
    verts, faces, _ = uv_sphere_mesh(16, 33)
    verts, faces = verts.astype(np.float32), faces.astype(np.int32)
    with jax.disable_jit(False):
        cam = wr.get_camera(num_views=2, elevation_deg=20.0, distance=2.7,
                            fovy_deg=40.0, near=0.1, far=10.0)
        pos = np.asarray(j_clip(jnp.asarray(verts), cam.mvp_mtx))
    rast = _np(pt.rasterize(_t(pos), _t(faces), (64, 64), device="cpu"))
    color = np.random.default_rng(5).random((2, 64, 64, 3)).astype(np.float32)
    assert (rast[..., 3] > 0).mean() > 0.2
    return color, rast, pos, faces


@pytest.mark.parametrize("analytic", [True, False], ids=["analytic", "fallback"])
def test_antialias_matches_jax(analytic):
    color, rast, pos, faces = _aa_inputs()
    extra = (pos, faces) if analytic else ()

    def ref(*a):
        return ja.antialias(*a)

    with jax.disable_jit():
        eager = np.asarray(ref(color, rast, *extra))
    jitted = np.asarray(jax.jit(ref)(color, rast, *extra))
    got = _np(pt.antialias(_t(color), _t(rast), *(_t(a) for a in extra),
                           device="cpu"))
    assert np.abs(got - color).max() > 0.05  # edges really blend
    np.testing.assert_array_equal(got, eager)
    # Jitted, the contracted edge values move each crossing t by its
    # rounding (2.3e-5 of colour at most on these inputs); a crossing that
    # flips would move a pixel by up to half a colour step.
    far = np.any(np.abs(got - jitted) > 1e-4, axis=-1)
    assert far.mean() <= 1e-3, far.mean()
