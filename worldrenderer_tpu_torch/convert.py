"""Build the port's objects from numpy arrays, so the port and the JAX
package can be handed the same state (a mesh, a camera batch, a
rasterizer config, an Adam optimizer's state)."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .camera import Camera
from .mesh import TexturedMesh
from .ops.rasterize import RasterizerConfig


def _f32(a, dev):
    return None if a is None else torch.tensor(
        np.asarray(a, np.float32), device=dev
    )


def _idx(a, dev):
    return None if a is None else torch.tensor(
        np.asarray(a, np.int64), device=dev
    )


def mesh_from_arrays(
    v_pos,
    t_pos_idx,
    v_nrm=None,
    v_tex=None,
    t_tex_idx=None,
    texture=None,
    device: DeviceLike = None,
) -> TexturedMesh:
    """TexturedMesh from (V, 3) positions, (T, 3) indices and the optional
    per-vertex normals, UVs, UV indices and texture image."""
    dev = resolve_device(device)
    return TexturedMesh(
        v_pos=_f32(v_pos, dev),
        t_pos_idx=_idx(t_pos_idx, dev),
        v_tex=_f32(v_tex, dev),
        t_tex_idx=_idx(t_tex_idx, dev),
        texture=_f32(texture, dev),
        v_nrm=_f32(v_nrm, dev),
    )


def camera_from_arrays(
    c2w: Optional[Any],
    w2c,
    proj_mtx,
    mvp_mtx,
    cam_pos: Optional[Any] = None,
    device: DeviceLike = None,
) -> Camera:
    """Camera from the fields of a camera batch, e.g. the JAX package's
    ``Camera`` converted with ``np.asarray`` field by field."""
    dev = resolve_device(device)
    return Camera(
        c2w=_f32(c2w, dev),
        w2c=_f32(w2c, dev),
        proj_mtx=_f32(proj_mtx, dev),
        mvp_mtx=_f32(mvp_mtx, dev),
        cam_pos=_f32(cam_pos, dev),
    )


def config_from_dict(fields: Mapping[str, Any]) -> RasterizerConfig:
    """RasterizerConfig from ``RasterizerConfig._asdict()`` of either
    package; unknown field names raise."""
    unknown = set(fields) - set(RasterizerConfig._fields)
    if unknown:
        raise ValueError(f"unknown RasterizerConfig fields: {sorted(unknown)}")
    return RasterizerConfig(**fields)


def adam_state_from_optax(count, mu, nu, device: DeviceLike = None) -> dict:
    """``torch.optim.Adam``'s state for one parameter from an optax Adam
    state's ``count``, ``mu`` and ``nu`` (``ScaleByAdamState``, as numpy):
    ``step`` (a float32 scalar on the host, as Adam keeps it),
    ``exp_avg`` and ``exp_avg_sq`` (float32 on ``device``). Install it with
    ``optimizer.state[param] = ...`` or hand it to
    ``parallel.make_texture_fit_step``'s step as ``opt_state``, so a fit
    carries on from the JAX package's."""
    dev = resolve_device(device)
    return {
        "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
        "exp_avg": _f32(mu, dev),
        "exp_avg_sq": _f32(nu, dev),
    }
