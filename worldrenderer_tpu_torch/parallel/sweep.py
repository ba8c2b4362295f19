"""View-split render sweeps and the data-parallel texture-fit step
(PyTorch counterpart of ``worldrenderer_tpu/parallel/sweep.py``).

The view axis is split into contiguous blocks, one per device of a mesh
(:func:`render_views_sharded`), or one per process of a
``torch.distributed`` group (:func:`make_texture_fit_step`, whose texture
gradient is all-reduced across the group).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..camera import Camera
from ..mesh import TexturedMesh
from ..ops.rasterize import DEFAULT_CONFIG, RasterizerConfig
from ..render import RenderOutput, render
from .device_mesh import DeviceMesh, view_sharding
from .dist import _comm_device, process_count, process_index

__all__ = ["render_views_sharded", "texture_fit_loss", "texture_fit_step",
           "make_texture_fit_step"]


def render_views_sharded(
    mesh: TexturedMesh,
    cam: Camera,
    height: int,
    width: int,
    device_mesh: DeviceMesh,
    **render_kwargs,
) -> RenderOutput:
    """Render a view batch with the leading view axis split over the device
    mesh's first axis: geometry and texture are copied to each device, and
    each device renders its contiguous block of views. The blocks are
    gathered into one ``RenderOutput`` on the mesh's first device (the JAX
    package returns arrays left sharded over its mesh). A view count the
    axis does not divide raises ``ValueError``."""
    if "device" in render_kwargs:
        raise ValueError("render_views_sharded takes its devices from device_mesh")
    blocks = view_sharding(device_mesh, device_mesh.axis_names[0]).blocks(len(cam))
    meshes = {}
    outs = []
    for dev, rows in blocks:
        if dev not in meshes:
            meshes[dev] = mesh.to(dev)
        outs.append(render(meshes[dev], cam[rows].to(dev), height, width,
                           device=dev, **render_kwargs))
    first = blocks[0][0]
    return RenderOutput(*(
        None if parts[0] is None else torch.cat([p.to(first) for p in parts])
        for parts in zip(*outs)))


def texture_fit_loss(
    texture: torch.Tensor,
    mesh: TexturedMesh,
    cam: Camera,
    target: torch.Tensor,
    height: int,
    width: int,
    attr_background: float = 0.5,
    raster_config: RasterizerConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """L2 photometric loss of the textured views rendered with ``texture``
    (through ``raster_config``) against ``target`` images, on ``texture``'s
    device: differentiable in the texture through the sampling chain
    (interpolate -> texture gather -> composite) though the z-buffered
    rasterization is piecewise constant in the geometry."""
    out = render(
        mesh,
        cam,
        height=height,
        width=width,
        render_attr=True,
        render_depth=False,
        render_normal=False,
        texture_override=texture,
        attr_background=attr_background,
        raster_config=raster_config,
        device=texture.device,
    )
    return torch.mean((out.attr - target) ** 2)


def _rank_views(n: int):
    """This process's contiguous block of ``n`` views and the count of
    every process's block (``np.array_split``'s)."""
    counts = [len(b) for b in np.array_split(np.arange(n), process_count())]
    start = sum(counts[:process_index()])
    return slice(start, start + counts[process_index()]), counts


def make_texture_fit_step(
    optimizer: torch.optim.Optimizer,
    height: int,
    width: int,
    attr_background: float = 0.5,
    raster_config: RasterizerConfig = DEFAULT_CONFIG,
):
    """Build a (texture, opt_state, mesh, cam, target) -> (texture,
    opt_state, loss) step: the loss and its gradient in the texture, then
    the optimizer's update, as the JAX package's step does with optax.

    ``texture`` is the leaf tensor ``optimizer`` updates in place;
    ``opt_state`` is the optimizer's state for it (``optimizer.state[
    texture]``, such as ``convert.adam_state_from_optax``'s), installed
    before the update, or None to keep the optimizer's own; the step
    returns the state after the update. Under a process group of W
    processes each renders its own contiguous block of the views, and the
    gradient is all-reduced weighted by each block's view count (the mean
    over all views' pixels), so one step is the single-process step on all
    views; the returned loss is the whole batch's."""

    def step(texture, opt_state, mesh, cam, target):
        if opt_state is not None:
            optimizer.state[texture] = opt_state
        optimizer.zero_grad(set_to_none=True)
        n = len(cam)
        rows, counts = _rank_views(n)
        loss = texture_fit_loss(texture, mesh, cam[rows], target[rows], height,
                                width, attr_background, raster_config)
        loss.backward()
        loss = loss.detach()
        if process_count() > 1:
            # One all-reduce of the gradient and the loss, each weighted by
            # this block's share of the views.
            share = counts[process_index()] / n
            both = torch.cat([texture.grad.reshape(-1), loss.reshape(1)]) * share
            both = both.to(_comm_device())
            dist.all_reduce(both)
            both = both.to(texture.device)
            texture.grad.copy_(both[:-1].reshape(texture.shape))
            loss = both[-1]
        optimizer.step()
        return texture, optimizer.state[texture], loss

    return step


def texture_fit_step(
    texture: torch.Tensor,
    opt_state,
    mesh: TexturedMesh,
    cam: Camera,
    target: torch.Tensor,
    optimizer: torch.optim.Optimizer,
    height: int,
    width: int,
    raster_config: RasterizerConfig = DEFAULT_CONFIG,
):
    """One optimization step (:func:`make_texture_fit_step`)."""
    step = make_texture_fit_step(optimizer, height, width,
                                 raster_config=raster_config)
    return step(texture, opt_state, mesh, cam, target)
