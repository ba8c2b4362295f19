"""Device resolution and the float -> int32 cast shared by the whole port.

Public entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without an explicit device they
raise instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises.

    On a CUDA device this also switches TF32 off for matmuls and
    convolutions: the geometry paths (MVP products, inverse-MVP
    unprojection) must be true fp32, as the JAX reference evaluates them
    at ``Precision.HIGHEST``. Both flags are process-wide."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def to_int32_sat(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 with XLA's semantics: truncate toward zero, saturate
    at the int32 range, NaN -> 0. ``Tensor.to(torch.int32)`` maps NaN, inf
    and out-of-range values to -2^31 instead, which would send a NaN bbox
    to another tile than the reference does."""
    x = torch.nan_to_num(x, nan=0.0)
    # float32 cannot hold 2^31 - 1: 2^31 is the first value out of range.
    hi = x >= 2.0**31
    lo = x <= -(2.0**31)
    safe = torch.where(hi | lo, torch.zeros_like(x), x)
    out = safe.to(torch.int32)
    out = torch.where(hi, torch.full_like(out, _I32_MAX), out)
    return torch.where(lo, torch.full_like(out, _I32_MIN), out)


def as_f32(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """Tensor (or array-like) as float32 on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)
