"""Build the CUDA kernels of ``csrc/`` with nvcc at first use and load them
through ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``, keyed by a
hash of the package's CUDA sources and the flags, so an edited source
rebuilds and an unchanged one loads. Every library has a plain C
interface: no PyTorch headers, which keeps a build to seconds. Kernels
target Hopper (``sm_90a``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false: no multiply-add contraction anywhere, so every kernel rounds
# as its plain PyTorch version does (the sources also spell the critical
# expressions with __fmul_rn / __fadd_rn). -Xptxas -v reports registers,
# shared memory and spills into the build log.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _target(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named library that is not built yet, one nvcc process
    per source, all started together. Returns each library's compiler
    output (ptxas resource usage); raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs: Dict[str, str] = {}
    running = {}
    for name in names:
        out = _target(name)
        log = out.with_suffix(".log")
        if out.exists():
            logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in running.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of library ``name``, returning an int
    (a CUDA error code), loaded and typed once."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def launch(name: str, symbol: str, argtypes: Sequence, device: torch.device,
           *args) -> None:
    """Call the launcher ``symbol`` of library ``name`` with ``args`` and,
    last, the current stream of ``device``, the CUDA device the kernel's
    tensors lie on; ``argtypes`` types ``args``. A device other than the
    current one is made current around the call. Raises on a nonzero CUDA
    error."""
    fn = function(name, symbol, [*argtypes, ctypes.c_void_p])
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")


def occupancy(name: str, symbol: str, a: int, b: int) -> Dict[str, int]:
    """A kernel's resources from the occupancy query ``symbol`` that library
    ``name`` exports, at its two shape arguments (the tile kernels' chunk
    size and tile width): registers per thread, shared memory per block
    (bytes) and resident blocks per SM."""
    fn = function(name, symbol,
                  [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3)
    regs, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(a, b, ctypes.byref(regs), ctypes.byref(smem),
             ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return {"registers": regs.value, "shared_bytes": smem.value,
            "blocks_per_sm": blocks.value}
