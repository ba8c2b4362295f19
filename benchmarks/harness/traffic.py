"""The traffic generator: a mix file (``traffic/<mix>.json``) names a
request ``kind`` and its parameters, and the configuration file names the
deployment's scene and the program's keywords. The kind is a module of
its own, ``kinds/<kind>.py``, found by name (``Manifest.kind``): its
``DRIVER`` (a ``Driver``) makes and runs the requests, its ``counts``
gives the numbers that decide ``correct``, ``spread`` and
``TRIAL_TOLERANCES`` serve the readings behind their limits, and an
optional ``trace_counts`` adds counts to a traced window's reading.

Every seed sends the same requests in size and number: the seed draws the
content (texture or images) and, where the kind has one, the path's
starting frame.
"""

from __future__ import annotations

import random
from typing import Dict, List

import torch

from . import scenes


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def make_texture(spec: Dict, seed: int, device) -> torch.Tensor:
    """The configuration's ``texture``: a constant ``fill``, or smooth
    noise drawn from the seed."""
    s = spec["size"]
    if "fill" in spec:
        return torch.full((s, s, 3), float(spec["fill"]), device=device)
    return scenes.smooth_noise(generator(seed, device), (1, s, s, 3),
                               spec["noise_cell"], spec["low"], spec["high"],
                               device)[0]


class Driver:
    """One cell's inputs, the program's objects and its requests.

    ``build`` makes what no seed changes (scene, cameras, the program's
    mesh and configuration); ``reseed`` draws the seed's inputs;
    ``warm`` runs one request of every shape the traffic uses;
    ``request(k)`` runs request k and returns its outputs; ``reference``
    recomputes a kept request's outputs with the plain reference.

    A configuration's top-level ``raster_backend`` names the
    ``RasterizerConfig`` backend of every raster configuration the driver
    hands the program (``with_backend``), where the deployment's default
    is not run."""

    work_unit = "requests"

    def __init__(self, config: Dict, mix: Dict, device: str):
        self.config, self.mix = config, mix
        self.device = torch.device(device)
        import worldrenderer_tpu_torch as pt  # the system under test

        self.pt = pt

    def with_backend(self, raster_config):
        backend = self.config.get("raster_backend")
        return raster_config._replace(backend=backend) if backend else raster_config

    def warm(self) -> None:
        self.request(0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sampler(self, seed: int) -> "Reservoir":
        return Reservoir(self.mix["check_requests"], seed)


class Reservoir:
    """The first request and a uniform sample, drawn from the seed, of the
    rest of a window whose length is not known in advance (reservoir
    sampling): ``size`` requests in all."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed ^ 0x5EED)
        self.first = None
        self.slots: List = []  # (k, outputs)
        self.seen = 0

    def offer(self, k: int, outputs) -> None:
        if self.first is None:
            self.first = (k, outputs)
            return
        self.seen += 1
        if len(self.slots) < self.size - 1:
            self.slots.append((k, outputs))
            return
        j = self.rng.randrange(self.seen)
        if j < self.size - 1:
            self.slots[j] = (k, outputs)

    @property
    def kept(self) -> Dict[int, object]:
        items = ([self.first] if self.first else []) + self.slots
        return dict(items)


def driver_for(manifest, config: Dict, mix: Dict, device: str) -> Driver:
    """The driver of ``mix``'s kind (``kinds/<kind>.py``) over ``config``."""
    return manifest.kind(mix["kind"]).DRIVER(config, mix, device)
