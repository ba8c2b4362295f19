"""Measurement probes of the PyTorch port: the three Pallas probes of the
JAX package's ``tools/`` as hand-written CUDA kernels, each with its plain
PyTorch version and a launch count. None of them is on a render path; each
module's ``main()`` is the probe's entry point on the card:

    python -m worldrenderer_tpu_torch.probes.chunk_stream   # P1
    python -m worldrenderer_tpu_torch.probes.transpose      # P2
    python -m worldrenderer_tpu_torch.probes.smem_gather    # P3
"""

from __future__ import annotations

import argparse

import torch


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card: CUDA events around
    ``reps`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def parse_device(argv, description: str) -> str:
    """A probe's command line: ``--device`` (the card unless "cpu")."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the plain version")
    return ap.parse_args(argv).device
