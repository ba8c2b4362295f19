"""Multi-process coordination over ``torch.distributed`` (PyTorch
counterpart of ``worldrenderer_tpu/parallel/dist.py``).

One process per card (nccl) or per CPU worker (gloo), joined over
``tcp://coordinator_address``. With one process, or before a group is
started, every call here is the single-process answer: rank 0, a barrier
that returns, a broadcast that hands the value back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device

__all__ = [
    "initialize_distributed",
    "process_index",
    "process_count",
    "is_main_process",
    "barrier",
    "broadcast_from_main",
]


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> None:
    """Join a process group of ``num_processes`` at ``coordinator_address``
    ("host:port") as rank ``process_id``: gloo when ``device`` is the CPU,
    nccl on the card (the default). A no-op for one process, or when a
    group is already up."""
    if num_processes is None or num_processes <= 1 or _group_up():
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address "
                         "and process_id for more than one process")
    dev = resolve_device(device)
    dist.init_process_group(
        backend="gloo" if dev.type == "cpu" else "nccl",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def process_index() -> int:
    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    return dist.get_world_size() if _group_up() else 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Global barrier; returns at once with one process."""
    if process_count() > 1:
        dist.barrier()


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the card for
    nccl, the host for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_main(value) -> np.ndarray:
    """Broadcast a host value (same shape and dtype on every process) from
    process 0 to all processes."""
    arr = np.asarray(value)
    if process_count() <= 1:
        return arr
    t = torch.as_tensor(np.ascontiguousarray(arr)).to(_comm_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()
