"""Tensor helpers: the small ones shared by the tile kernels' wrappers
and plain versions, then the JAX package's public helpers of
``worldrenderer_tpu/ops/tensor.py`` (activations, micro-batching,
ray / box intersection, polar <-> c2w, Fourier position encoding)."""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..camera import normalize, rigid_inverse
from ..transforms import cross, dot, fma_f32

__all__ = [
    "reflect",
    "scale_tensor",
    "trunc_exp",
    "get_activation",
    "chunk_batch",
    "get_mvp_matrix",
    "rays_intersect_bbox",
    "get_plucker_rays",
    "c2w_to_polar",
    "polar_to_c2w",
    "fourier_position_encoding",
    "edge0_pad_block",
]

# e0 constant of an invalid or padded entry: swallows any tile-origin
# rebase exactly in f32, so the entry never covers a pixel.
BIG_NEG = -3.0e38

# Tiles the plain versions evaluate together: their float64 FMA emulation
# keeps a step's temporaries at a few hundred MB.
PLAIN_TILES_PER_STEP = 8


def route(name: str, device: torch.device, plain, launch):
    """A tile kernel's wrapper: ``plain()`` for CPU tensors, ``launch()``
    (the CUDA kernel) for CUDA tensors; any other device raises."""
    if device.type == "cpu":
        return plain()
    if device.type != "cuda":
        raise ValueError(f"no {name} route for device {device}")
    return launch()


def chunk_size(chunk: int) -> int:
    """The chunk the tile kernels run with: a multiple of 128, at least
    128."""
    return max(128, (chunk // 128) * 128)


def edge0_pad_block(r: int, pad: int, dtype, neg: float,
                    device=None) -> torch.Tensor:
    """A ``(3, r, pad)`` plane-coefficient padding block, zero except the
    edge-0 constant row ``[2, 0, :]``, which is ``neg``: padded rasterizer
    slots are never covered."""
    block = torch.zeros((3, r, pad), dtype=dtype, device=device)
    block[2, 0] = neg
    return block


def pad_tile_blocks(coeffs: torch.Tensor, r: int, counts: torch.Tensor,
                    chunk: int):
    """A dense (n_tiles, 3, r*K) coefficient block as (n_tiles, 3, r, Kp),
    K padded to a multiple of the chunk c by never-covering slots, as the
    TPU wrappers pad; the chunks each tile scans, ceil(count / c); c."""
    n_tiles = coeffs.shape[0]
    k = coeffs.shape[2] // r
    c = chunk_size(chunk)
    co = coeffs.reshape(n_tiles, 3, r, k)
    pad = (-k) % c
    if pad:
        block = edge0_pad_block(r, pad, coeffs.dtype, BIG_NEG, coeffs.device)
        co = torch.cat([co, block.expand(n_tiles, 3, r, pad)], dim=3)
    nch = (counts.long().clamp(0, k) + (c - 1)) // c
    return co, nch, c


def pixel_centres(tile_h: int, tile_w: int, device=None):
    """(lx, ly) f32 pixel centres of a tile, row-major."""
    pix = torch.arange(tile_h * tile_w, device=device)
    return ((pix % tile_w).to(torch.float32) + 0.5,
            (pix // tile_w).to(torch.float32) + 0.5)


def plane_dot(a, b, g, lx, ly) -> torch.Tensor:
    """``a*lx + b*ly + g`` rounded as the JAX package's fp32 plane dot
    ``(a, b, g) . (lx, ly, 1)`` at ``Precision.HIGHEST`` rounds on the CPU:
    ``fma(b, ly, a*lx) + g``. The tile kernels K2 and K4 evaluate in this
    order."""
    return fma_f32(b.double(), ly.double(), (a * lx).double()) + g


def plane_vpu(a, b, g, lx, ly) -> torch.Tensor:
    """``lx*a + ly*b + g`` rounded as XLA contracts the jitted elementwise
    form on the CPU: ``fma(lx, a, ly*b) + g``. Kernel K3 evaluates in this
    order."""
    return fma_f32(lx.double(), a.double(), (ly * b).double()) + g


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 square root, on the CPU as on the card (and
    as XLA's): PyTorch's vectorized fp32 ``sqrt`` on the CPU misses the
    correctly rounded result for some inputs; the float64 root rounded to
    fp32 is exact (53 >= 2 * 24 + 2)."""
    return torch.sqrt(x.double()).float()


def fma_dot3(x: torch.Tensor, y: torch.Tensor, dim: int) -> torch.Tensor:
    """``sum_i x_i * y_i`` over the three entries of ``dim``, rounded as
    the reference's 3-term fp32 ``einsum`` at ``Precision.HIGHEST`` rounds
    on the CPU: ``fma(x2, y2, fma(x1, y1, x0 * y0))``."""
    x0, x1, x2 = x.unbind(dim)
    y0, y1, y2 = y.unbind(dim)
    acc = fma_f32(x1.double(), y1.double(), (x0 * y0).double()).double()
    return fma_f32(x2.double(), y2.double(), acc)


# ---- the JAX package's public tensor helpers (``ops/tensor.py:25-306``) ----


def reflect(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect ``x`` about the normals ``n`` (last axis)."""
    return 2 * dot(x, n) * n - x


def scale_tensor(dat, inp_scale=None, tgt_scale=None):
    """Map ``dat`` linearly from ``inp_scale`` (default (0, 1)) to
    ``tgt_scale`` (default (0, 1))."""
    if inp_scale is None:
        inp_scale = (0, 1)
    if tgt_scale is None:
        tgt_scale = (0, 1)
    dat = (dat - inp_scale[0]) / (inp_scale[1] - inp_scale[0])
    return dat * (tgt_scale[1] - tgt_scale[0]) + tgt_scale[0]


class _TruncExp(torch.autograd.Function):
    """exp whose derivative is taken at clamp(x, max=15)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with its gradient computed at clamp(x, max=15), which keeps
    density activations from infinite gradients (the JAX package's
    ``custom_jvp``)."""
    return _TruncExp.apply(x)


def _lin2srgb(x: torch.Tensor) -> torch.Tensor:
    srgb = torch.pow(torch.clamp(x, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055
    return torch.clamp(torch.where(x > 0.0031308, srgb, 12.92 * x), 0.0, 1.0)


_ACTIVATIONS = {
    "none": lambda x: x,
    "lin2srgb": _lin2srgb,
    "exp": torch.exp,
    "shifted_exp": lambda x: torch.exp(x - 1.0),
    "trunc_exp": trunc_exp,
    "shifted_trunc_exp": lambda x: trunc_exp(x - 1.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "shifted_softplus": lambda x: F.softplus(x - 1.0),
    "scale_-11_01": lambda x: x * 0.5 + 0.5,
    "negative": lambda x: -x,
}


def get_activation(name: Optional[str]) -> Callable:
    """Named activation: the table above, else the function of that name
    in ``torch.nn.functional``; an unknown name raises ``ValueError``."""
    if name is None:
        return lambda x: x
    name = name.lower()
    if name in _ACTIVATIONS:
        return _ACTIVATIONS[name]
    fn = getattr(F, name, None)
    if callable(fn):
        return fn
    raise ValueError(f"Unknown activation function: {name}")


def _is_batched(a) -> bool:
    return isinstance(a, (torch.Tensor, np.ndarray)) and a.ndim > 0


def _cat(parts):
    if all(isinstance(p, np.ndarray) for p in parts):
        return np.concatenate(parts, axis=0)
    return torch.cat([torch.as_tensor(p) for p in parts], dim=0)


def chunk_batch(func: Callable, chunk_size: int, *args, **kwargs) -> Any:
    """Call ``func`` on slices of ``chunk_size`` along the leading axis of
    every array argument and concatenate what it returns: an array, or a
    dict, tuple or list of arrays. ``chunk_size <= 0`` calls it once."""
    if chunk_size <= 0:
        return func(*args, **kwargs)
    batch = next((a.shape[0] for a in list(args) + list(kwargs.values())
                  if _is_batched(a)), None)
    if batch is None:
        raise ValueError("chunk_batch: no array argument gives a batch size")

    def piece(a, i):
        return a[i:i + chunk_size] if _is_batched(a) else a

    out = defaultdict(list)
    out_type = None
    for i in range(0, max(1, batch), chunk_size):
        chunk = func(*[piece(a, i) for a in args],
                     **{k: piece(a, i) for k, a in kwargs.items()})
        if chunk is None:
            continue
        out_type = type(chunk)
        if isinstance(chunk, (torch.Tensor, np.ndarray)):
            items = {0: chunk}
        elif isinstance(chunk, dict):
            items = chunk
        elif isinstance(chunk, (tuple, list)):
            items = dict(enumerate(chunk))
        else:
            raise TypeError(f"unsupported chunk_batch return type {type(chunk)}")
        for k, v in items.items():
            out[k].append(v)
    if out_type is None:
        return None
    merged = {k: _cat(v) for k, v in out.items()}
    if issubclass(out_type, (torch.Tensor, np.ndarray)):
        return merged[0]
    if issubclass(out_type, dict):
        return merged
    return out_type([merged[i] for i in range(len(merged))])


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for small matrices as exact fp32 products summed along
    the contraction: never a TF32 matmul on the card."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def get_mvp_matrix(c2w: torch.Tensor, proj_mtx: torch.Tensor) -> torch.Tensor:
    """MVP matrices from (N, 4, 4) or (4, 4) c2w through the analytic rigid
    inverse."""
    squeeze = c2w.ndim == 2
    if squeeze:
        c2w, proj_mtx = c2w[None], proj_mtx[None]
    mvp = matmul_f32(proj_mtx, rigid_inverse(c2w))
    return mvp[0] if squeeze else mvp


def rays_intersect_bbox(rays_o: torch.Tensor, rays_d: torch.Tensor,
                        radius, near: float = 0.0, valid_thresh: float = 0.01):
    """Slab-method ray / axis-aligned box intersection; ``radius`` a
    number (the box [-r, r]^3) or (3, 2) bounds. Returns (t_near (..., 1),
    t_far (..., 1), rays_valid (...))."""
    input_shape = rays_o.shape[:-1]
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    rays_d = torch.where(rays_d.abs() < 1e-6, 1e-6, rays_d)
    if isinstance(radius, (int, float)):
        radius = torch.tensor([[-radius, radius]] * 3, dtype=torch.float32,
                              device=rays_o.device)
    radius = (1.0 - 1.0e-3) * radius
    i0 = (radius[..., 1] - rays_o) / rays_d
    i1 = (radius[..., 0] - rays_o) / rays_d
    t_near = torch.clamp(torch.minimum(i0, i1).amax(dim=-1), min=near)
    t_far = torch.maximum(i0, i1).amin(dim=-1)
    rays_valid = t_far - t_near > valid_thresh
    t_near = torch.where(rays_valid, t_near, 0.0)
    t_far = torch.where(rays_valid, t_far, 0.0)
    return (t_near.reshape(*input_shape, 1), t_far.reshape(*input_shape, 1),
            rays_valid.reshape(*input_shape))


def get_plucker_rays(rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Plücker 6-vector (o x d, d) of normalized origins and directions."""
    rays_o = normalize(rays_o)
    rays_d = normalize(rays_d)
    return torch.cat([cross(rays_o, rays_d), rays_d], dim=-1)


def c2w_to_polar(c2w) -> Tuple[float, float, float]:
    """(elevation, azimuth, distance) in radians of a c2w matrix's camera
    position, as host scalars."""
    if isinstance(c2w, torch.Tensor):
        c2w = c2w.detach().cpu().numpy()
    cam_pos = np.asarray(c2w)[:3, 3]
    x, y, z = cam_pos.tolist()
    distance = float(np.linalg.norm(cam_pos))
    elevation = math.asin(z / distance)
    if abs(x) < 1.0e-5 and abs(y) < 1.0e-5:
        azimuth = 0.0
    else:
        azimuth = math.atan2(y, x)
        if azimuth < 0:
            azimuth += 2 * math.pi
    return elevation, azimuth, distance


def polar_to_c2w(elevation: float, azimuth: float, distance: float) -> np.ndarray:
    """Z-up look-at c2w (a host (4, 4) float32 array) from polar
    coordinates in radians."""
    z = distance * math.sin(elevation)
    x = distance * math.cos(elevation) * math.cos(azimuth)
    y = distance * math.cos(elevation) * math.sin(azimuth)
    lookat = -np.array([x, y, z], np.float64)
    lookat /= np.linalg.norm(lookat)
    up = np.array([0.0, 0.0, 1.0])
    s = np.cross(lookat, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, lookat)
    rot = np.stack([s, u, -lookat], axis=0).T
    c2w = np.zeros((4, 4), np.float32)
    c2w[:3, :3] = rot
    c2w[:3, 3] = [x, y, z]
    c2w[3, 3] = 1.0
    return c2w


def get_intrinsic_from_fov(fov: float, height: int, width: int, bs: int = -1,
                           device: DeviceLike = None) -> torch.Tensor:
    """Pinhole intrinsics (3, 3), or (bs, 3, 3), from a vertical fov in
    radians, on ``device`` (the card unless ``device="cpu"``)."""
    focal = 0.5 * height / math.tan(0.5 * fov)
    intr = np.identity(3, dtype=np.float32)
    intr[0, 0] = focal
    intr[1, 1] = focal
    intr[0, 2] = width / 2.0
    intr[1, 2] = height / 2.0
    if bs > 0:
        intr = np.repeat(intr[None], bs, axis=0)
    return torch.from_numpy(intr).to(resolve_device(device))


def binary_cross_entropy(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy, written out: no clamping of the logs."""
    return -torch.mean(target * torch.log(input)
                       + (1.0 - target) * torch.log(1.0 - input))


def _bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def tet_sdf_diff(vert_sdf: torch.Tensor, tet_edges: torch.Tensor) -> torch.Tensor:
    """Sign-consistency loss over the tet edges that cross the SDF's zero
    level: each crossing edge's two-way BCE with logits, averaged over the
    crossing edges (static shapes: other edges weigh 0)."""
    s = vert_sdf[:, 0][tet_edges.reshape(-1)].reshape(-1, 2)
    crossing = torch.sign(s[:, 0]) != torch.sign(s[:, 1])
    per_edge = (_bce_logits(s[:, 0], (s[:, 1] > 0).to(s.dtype))
                + _bce_logits(s[:, 1], (s[:, 0] > 0).to(s.dtype)))
    n = torch.clamp(crossing.sum(), min=1)
    return torch.where(crossing, per_edge, 0.0).sum() / n


def validate_empty_rays(ray_indices, t_start, t_end):
    """One dummy ray in place of an empty ray set (a host-side guard)."""
    is_tensor = isinstance(ray_indices, torch.Tensor)
    if (ray_indices.numel() if is_tensor else np.asarray(ray_indices).size) == 0:
        dev = ray_indices.device if is_tensor else torch.device("cpu")
        ray_indices = torch.zeros((1,), dtype=torch.int32, device=dev)
        t_start = torch.zeros((1,), dtype=torch.float32, device=dev)
        t_end = torch.zeros((1,), dtype=torch.float32, device=dev)
    return ray_indices, t_start, t_end


def fourier_position_encoding(x: torch.Tensor, n_freq: int, dim: int) -> torch.Tensor:
    """sin and cos features of ``x`` at the octave frequencies 2^0 ..
    2^(n_freq-1), stacked along ``dim``."""
    if n_freq <= 0:
        raise ValueError("n_freq must be positive")
    input_shape = tuple(x.shape)
    ndim = x.ndim
    if dim < 0:
        dim = ndim + dim
    bands = 2.0 ** torch.arange(n_freq, dtype=x.dtype, device=x.device)
    bands = bands.reshape((1,) * (dim + 1) + (n_freq,) + (1,) * (ndim - dim - 1))
    x = x.reshape(input_shape[:dim + 1] + (1,) + input_shape[dim + 1:])
    out_shape = input_shape[:dim] + (-1,) + input_shape[dim + 1:]
    sin = torch.sin(bands * x).reshape(out_shape)
    cos = torch.cos(bands * x).reshape(out_shape)
    return torch.cat([sin, cos], dim=dim)
