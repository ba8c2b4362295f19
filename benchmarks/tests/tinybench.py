"""Shared pieces of the harness's tests: paths, the card check, and a
copy of the benchmark cut to tiny sizes."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: pytest -m chip)")


# Tiny sizes of each configuration and mix, for CPU runs of the whole flow.
TINY_CONFIG = {
    "wr-terrain-1m-classic": {"scene": {"grid_n": 50}, "texture": {"size": 64},
                      "render": {"height": 48, "width": 64},
                      "bake": {"uv_size": 64}},
    "mvadapter-tex4k-classic": {"scene": {"n_lat": 17, "n_lon": 33},
                        "texture": {"size": 64}, "bake": {"uv_size": 64}},
}
TINY_TRAFFIC = {
    "path-rerender": {"frames_per_request": 4, "cameras": {"frames": 24}},
    "sixview-bake": {"image_size": [48, 48], "image_texture_size": 256},
    "keyframe-bake": {"image_size": [48, 48], "image_texture_size": 64,
                      "cameras": {"frames": 24}},
}


def _merge(base, over):
    for k, v in over.items():
        if isinstance(v, dict):
            _merge(base[k], v)
        else:
            base[k] = v


def make_tiny_bench(tmp: Path) -> Path:
    """A copy of the benchmark in ``tmp`` (``BENCHMARK.json`` and
    ``benchmarks/``) with every configuration and mix cut to tiny sizes.
    Returns the copy's root."""
    bench = tmp / "benchmarks"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub, table in (("configs", TINY_CONFIG), ("traffic", TINY_TRAFFIC)):
        for name, over in table.items():
            path = bench / sub / f"{name}.json"
            data = json.loads(path.read_text())
            _merge(data, over)
            path.write_text(json.dumps(data))
    return tmp
