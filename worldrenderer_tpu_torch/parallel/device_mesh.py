"""Device meshes and placements (PyTorch counterpart of
``worldrenderer_tpu/parallel/device_mesh.py``).

A :class:`DeviceMesh` is a numpy array of ``torch.device``s with named
axes; it needs no process group (``torch.distributed.DeviceMesh`` does).
Devices may repeat: a mesh of eight CPU slots splits views and texel bands
eight ways in one process, as the JAX package's tests do over eight
virtual CPU devices.

Axis convention:
  * ``views`` — the batch-of-views axis;
  * ``uv`` — the texel rows of a bake;
  * ``data`` — an outer jobs axis for dataset-scale sweeps.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["DeviceMesh", "Placement", "make_device_mesh", "view_sharding",
           "replicated_sharding"]


class DeviceMesh:
    """``devices``: an array of ``torch.device`` whose axes carry
    ``axis_names``. ``shape`` maps each axis name to its size, as a JAX
    mesh's does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devices.shape} for axes "
                             f"{tuple(axis_names)}")
        self.devices = np.vectorize(torch.device, otypes=[object])(devices)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def along(self, axis: str) -> List[torch.device]:
        """The devices that hold the blocks of ``axis``, in block order (the
        first device of each block's slice of the other axes)."""
        i = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, i, 0).reshape(
            self.devices.shape[i], -1)[:, 0])

    def distinct(self) -> List[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.reshape(-1)))

    def __repr__(self) -> str:
        return f"DeviceMesh({dict(self.shape)}, {self.distinct()})"


def make_device_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("views",),
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """Build a device mesh. Default: a 1-D mesh over every local CUDA device
    with a single ``views`` axis. ``shape`` must multiply to at most the
    device count (the first devices are taken)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_device_mesh: no CUDA device; pass devices= (such as "
                "[torch.device('cpu')] * 8) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if shape is None:
        shape = (len(devices),)
        axis_names = tuple(axis_names)[:1]
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    return DeviceMesh(arr.reshape(shape), tuple(axis_names))


class Placement(NamedTuple):
    """Where a tensor lives on a mesh: split along its leading axis over
    the mesh axis ``axis`` in contiguous blocks, or replicated on every
    device when ``axis`` is None."""

    mesh: DeviceMesh
    axis: Optional[str] = None

    def blocks(self, n: int) -> List[Tuple[torch.device, slice]]:
        """(device, rows) for each block of ``n`` leading rows; raises
        ``ValueError`` when the axis does not divide ``n``."""
        if self.axis is None:
            return [(d, slice(0, n)) for d in self.mesh.distinct()]
        k = self.mesh.shape[self.axis]
        if n % k:
            raise ValueError(f"{n} rows do not divide over mesh axis "
                             f"'{self.axis}' of size {k}")
        step = n // k
        return [(d, slice(i * step, (i + 1) * step))
                for i, d in enumerate(self.mesh.along(self.axis))]


def view_sharding(mesh: DeviceMesh, axis: str = "views") -> Placement:
    """The leading (view) axis split across ``axis``."""
    return Placement(mesh, axis)


def replicated_sharding(mesh: DeviceMesh) -> Placement:
    """A copy on every device of the mesh (geometry, textures, cameras)."""
    return Placement(mesh, None)
