"""The readings that a cell's correctness limits are set from: on each of
several seeds, the program's numbers and the control's, at the cell's own
sizes and load, over as many requests as a run compares.

The control is the plain reference with its clip transforms' operands
rounded to TF32 (``reference.raster.round_tf32``): the reference put in
the program's place, one precision below the float32-with-TF32-off that
the program's geometry states. A sound program reads under each limit; the
control reads over at least one. The witness (``witness``) is the same
reference computed in float32: what rounding to the program's precision
alone gives against the float64 reference.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import check
from .manifest import Manifest
from .traffic import driver_for

QUANTILES = (0.5, 0.9, 0.99, 0.999, 1.0)


def quantiles(x: torch.Tensor) -> List[float]:
    """``QUANTILES`` of the values of ``x``."""
    if x.numel() == 0:
        return []
    x = x.double().flatten()
    if x.numel() > 1 << 24:  # torch.quantile's limit; a strided sample
        x = x[:: -(-x.numel() // (1 << 24))]
    q = torch.tensor(QUANTILES, dtype=torch.float64, device=x.device)
    return [float(v) for v in torch.quantile(x, q)]


def _by_tolerance(kind, sides: Dict[str, list], spec) -> Dict:
    """Each trial tolerance's share, per side: {number: {tol: {side: v}}}."""
    out = {}
    for name, tols in kind.TRIAL_TOLERANCES.items():
        out[name] = {}
        for t in tols:
            s = {"numbers": {**spec["numbers"], name: {"tolerance": t, "limit": 0}}}
            out[name][repr(t)] = {side: check.numbers(kind.counts, pairs, s)[name]
                                  for side, pairs in sides.items() if pairs}
    return out


def collect(manifest: Manifest, workload: str, seeds: List[int],
            device: str = "cuda", control: bool = True, witness: bool = False):
    """For each seed: the program's numbers (``program``) and, with
    ``control``, the control's (``control``), with ``witness`` the float32
    reference's (``witness``), the spreads behind them and each trial
    tolerance's shares, one seed at a time. Requests 0 .. check_requests
    - 1 of each seed are compared."""
    cell = manifest.workload(workload)
    mix = manifest.traffic(cell["traffic"])
    spec = manifest.checks(workload)
    kind = manifest.kind(mix["kind"])
    driver = driver_for(manifest, manifest.config(cell["config"]), mix, device)
    driver.build()
    others = {"control": {"tf32": True}} if control else {}
    if witness:
        others["witness"] = {"dtype": torch.float32}
    for seed in seeds:
        driver.reseed(seed)
        kept = {k: driver.request(k) for k in range(mix["check_requests"])}
        row = {"seed": seed, "spread": {}}
        sides: Dict[str, list] = {"program": []}
        for k, out in kept.items():
            ref = driver.reference(k)
            got = {"program": driver.program_outputs(out)}
            for side, kw in others.items():
                got[side] = driver.reference(k, **kw)
            for side, outs in got.items():
                sides.setdefault(side, []).append((outs, ref))
                row["spread"].setdefault(side, []).append(
                    kind.spread(outs, ref, quantiles))
        for side, pairs in sides.items():
            row[side] = check.numbers(kind.counts, pairs, spec)
        row["by_tolerance"] = _by_tolerance(kind, sides, spec)
        yield row
        del kept, sides
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
