"""Runtime misc (PyTorch counterpart of ``worldrenderer_tpu/utils/misc.py``):
rank discovery, span profiler, scalar schedules, checkpoint IO, device
memory reporting, dynamic class lookup.

A span's device sync is ``torch.cuda.synchronize`` on the given tensors'
card; memory figures are ``torch.cuda.memory_stats`` under the JAX
package's key names; checkpoints are the JAX package's npz, so one file
loads in either package.
"""

from __future__ import annotations

import importlib
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "get_rank",
    "find",
    "cleanup",
    "C",
    "TimeRecorder",
    "time_recorder",
    "time_recorder_enabled",
    "device_memory_stats",
    "show_device_memory",
    "save_checkpoint",
    "load_checkpoint",
    "load_module_weights",
]


def get_rank() -> int:
    """Env-var rank discovery, SLURM included; falls through to
    ``torch.distributed.get_rank()`` when a process group is initialized,
    else 0."""
    rank_keys = ("RANK", "LOCAL_RANK", "SLURM_PROCID", "JSM_NAMESPACE_RANK")
    for key in rank_keys:
        rank = os.environ.get(key)
        if rank is not None:
            return int(rank)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def find(cls_string: str):
    """Dynamic 'pkg.module.Class' import."""
    module_string = ".".join(cls_string.split(".")[:-1])
    cls_name = cls_string.split(".")[-1]
    module = importlib.import_module(module_string, package=None)
    return getattr(module, cls_name)


def cleanup() -> None:
    """Free host garbage and the card's cached blocks."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def C(value: Any, epoch: int, global_step: int) -> float:
    """Scalar schedule: number, or [start_step, start_value, end_value,
    end_step] linear interpolation; float end_step keys on epoch."""
    if isinstance(value, (int, float)):
        return value
    if not isinstance(value, (list, tuple)):
        raise TypeError(f"Scalar specification only supports list, got {type(value)}")
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    assert len(value) == 4
    start_step, start_value, end_value, end_step = value
    current = epoch if isinstance(end_step, float) else global_step
    frac = max(min(1.0, (current - start_step) / (end_step - start_step)), 0.0)
    return start_value + (end_value - start_value) * frac


def _cuda_devices(block_on) -> set:
    """The CUDA devices of the tensors in ``block_on`` (a tensor, or a
    list / tuple / dict of them, nested)."""
    if isinstance(block_on, torch.Tensor):
        return {block_on.device} if block_on.is_cuda else set()
    if isinstance(block_on, dict):
        block_on = list(block_on.values())
    if isinstance(block_on, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in block_on))
    return set()


class TimeRecorder:
    """Singleton span profiler with device-sync-accurate timings: a span
    given tensors waits for their card (``torch.cuda.synchronize``) before
    it reads the clock."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.items = {}
            cls._instance.accumulations = defaultdict(list)
            cls._instance.time_scale = 1000.0
            cls._instance.time_unit = "ms"
            cls._instance.enabled = False
        return cls._instance

    def enable(self, enabled: bool) -> None:
        self.enabled = enabled

    def _sync(self, block_on=None) -> None:
        if block_on is not None:
            for dev in _cuda_devices(block_on):
                torch.cuda.synchronize(dev)

    def start(self, name: str, block_on=None) -> None:
        if not self.enabled:
            return
        self._sync(block_on)
        self.items[name] = time.perf_counter()

    def end(self, name: str, accumulate: bool = False, block_on=None) -> Optional[float]:
        if not self.enabled or name not in self.items:
            return None
        self._sync(block_on)
        delta = time.perf_counter() - self.items.pop(name)
        if accumulate:
            self.accumulations[name].append(delta)
        t = delta * self.time_scale
        logger.info(f"{name}: {t:.2f}{self.time_unit}")
        return t

    def get_accumulation(self, name: str, average: bool = False) -> Optional[float]:
        if not self.enabled or name not in self.accumulations:
            return None
        acc = self.accumulations.pop(name)
        total = sum(acc)
        t = (total / len(acc) if average else total) * self.time_scale
        logger.info(f"{name} for {len(acc)} times: {t:.2f}{self.time_unit}")
        return t


time_recorder = TimeRecorder()


@contextmanager
def time_recorder_enabled():
    prev = time_recorder.enabled
    time_recorder.enable(True)
    try:
        yield time_recorder
    finally:
        time_recorder.enable(prev)


def device_memory_stats() -> Dict[str, int]:
    """The current card's memory figures under the JAX package's key
    names: ``bytes_in_use``, ``bytes_limit`` and ``peak_bytes_in_use`` (the
    caching allocator's current, total and peak allocated bytes); empty
    without a card."""
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda", torch.cuda.current_device())
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
    }


def show_device_memory(name: str) -> None:
    stats = device_memory_stats()
    used = stats.get("bytes_in_use", 0)
    limit = stats.get("bytes_limit", 0)
    try:
        import psutil

        rss = psutil.Process(os.getpid()).memory_info().rss
    except ImportError:
        rss = 0
    logger.info(
        f"{name}: device {used / 1024**2:.1f}MB / {limit / 1024**2:.1f}MB, "
        f"host rss {rss / 1024**2:.1f}MB"
    )


# --------------------------------------------------------------------------
# Checkpointing: the JAX package's npz, keys joined with dots
# --------------------------------------------------------------------------


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, state: dict, epoch: int = 0, global_step: int = 0) -> None:
    """Save a nested dict of arrays and tensors as one npz, its keys joined
    with dots, beside ``__epoch__`` and ``__global_step__``."""
    flat = {}

    def flatten(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                flatten(prefix + k + ".", v)
        else:
            flat[prefix[:-1]] = _to_numpy(obj)

    flatten("", state)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __epoch__=np.asarray(epoch),
             __global_step__=np.asarray(global_step), **flat)


def load_checkpoint(path: str) -> Tuple[dict, int, int]:
    """Load an npz checkpoint back into a nested dict of numpy arrays +
    counters."""
    data = np.load(path, allow_pickle=False)
    epoch = int(data["__epoch__"])
    global_step = int(data["__global_step__"])
    state: dict = {}
    for k in data.files:
        if k.startswith("__"):
            continue
        cur = state
        parts = k.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = data[k]
    return state, epoch, global_step


def load_module_weights(
    path: str,
    module_name: Optional[str] = None,
    ignore_modules=None,
    mapping=None,
    module: Optional[torch.nn.Module] = None,
) -> Tuple[dict, int, int]:
    """Checkpoint loading with submodule selection / ignore / key remapping,
    over flat dotted keys. Returns (flat state, epoch, global_step); with
    ``module``, the state is also loaded into that ``nn.Module``
    (``load_state_dict``, each array as a tensor on the module's
    parameters' device)."""
    if module_name is not None and ignore_modules is not None:
        raise ValueError("module_name and ignore_modules cannot be both set")
    state, epoch, global_step = load_checkpoint(path)

    def flatten(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flatten(v, prefix + k + "."))
            else:
                out[prefix + k] = v
        return out

    flat = flatten(state)

    if mapping is not None:
        remapped = {
            k: v
            for k, v in flat.items()
            if not any(k.startswith(m["to"]) for m in mapping)
        }
        for k, v in flat.items():
            for m in mapping:
                if k.startswith(m["from"]):
                    remapped[k.replace(m["from"], m["to"], 1)] = v
        flat = remapped

    if ignore_modules is not None:
        flat = {
            k: v
            for k, v in flat.items()
            if not any(k.startswith(ig + ".") for ig in ignore_modules)
        }

    if module_name is not None:
        prefix = module_name + "."
        flat = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}

    if module is not None:
        params = list(module.parameters()) + list(module.buffers())
        dev = params[0].device if params else torch.device("cpu")
        module.load_state_dict(
            {k: torch.as_tensor(v, device=dev) for k, v in flat.items()})
    return flat, epoch, global_step
