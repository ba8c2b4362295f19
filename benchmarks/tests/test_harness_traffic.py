"""The traffic generator is deterministic by seed, and every seed sends
requests of the same sizes."""

import numpy as np
import torch

import tinybench  # noqa: F401  (puts the harness on the path)
from harness import scenes
from harness.traffic import Reservoir, driver_for


def test_smooth_noise_is_the_seeds():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return scenes.smooth_noise(g, (2, 24, 40, 3), 4, 0.1, 0.9, "cpu")

    a, b, c = draw(2**33 + 5), draw(2**33 + 5), draw(2**33 + 6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (2, 24, 40, 3)
    assert float(a.min()) >= 0.1 and float(a.max()) <= 0.9


def test_cameras_and_scenes_do_not_depend_on_the_seed():
    spec = {"kind": "path", "frames": 24, "every": 5, "azimuth_start_deg": 20.0,
            "azimuth_step_deg": 1.0, "elevation_deg": [30.0, 10.0],
            "distance": [2.5, 0.5], "fovy_deg": 50.0, "near": 0.1, "far": 10.0}
    a = scenes.request_cameras(spec, 32, 48)
    b = scenes.request_cameras(spec, 32, 48)
    assert a["mvp"].shape == (5, 4, 4)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    # Each camera looks at the origin: it projects to the image's centre.
    o = a["mvp"] @ np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    assert np.allclose(o[:, :2] / o[:, 3:4], 0.0, atol=1e-6)
    v, f, uv = scenes.grid_mesh(5, 1.0, 0.3, 3.0)
    assert v.shape == (25, 3) and f.shape == (32, 3) and uv.min() == 0 and uv.max() == 1
    v, f, uv = scenes.uv_sphere(5, 9, 0.5)
    assert np.allclose(np.linalg.norm(v, axis=1), 0.5)


def test_render_requests_are_the_seeds(tiny_manifest):
    cell = tiny_manifest.workload("terrain-rerender-classic")
    mix = tiny_manifest.traffic(cell["traffic"])
    d = driver_for(tiny_manifest, tiny_manifest.config(cell["config"]), mix, "cpu")
    d.build()
    d.reseed(2**34 + 1)
    first = (d.frames(0), d.frames(7), d.scene["texture"].clone())
    d.reseed(2**34 + 2)
    other = d.frames(0)
    d.reseed(2**34 + 1)
    assert (d.frames(0), d.frames(7)) == first[:2]
    assert torch.equal(d.scene["texture"], first[2])
    # Every seed renders chunks of the same size along the same path.
    assert len(other) == len(first[0]) == mix["frames_per_request"]
    assert d.frames(1)[0] == (d.frames(0)[-1] + 1) % mix["cameras"]["frames"]


def test_bake_requests_are_the_seeds(tiny_manifest):
    cell = tiny_manifest.workload("tex4k-bake-classic")
    d = driver_for(tiny_manifest, tiny_manifest.config(cell["config"]),
                   tiny_manifest.traffic(cell["traffic"]), "cpu")
    d.build()
    d.reseed(7)
    a = d.images.clone()
    d.reseed(8)
    b = d.images.clone()
    d.reseed(7)
    assert torch.equal(a, d.images) and not torch.equal(a, b)
    assert a.shape == b.shape == (4, 6, 48, 48, 3)


def test_reservoir_keeps_the_first_and_a_seeded_sample():
    def run(seed, n):
        r = Reservoir(3, seed)
        for k in range(n):
            r.offer(k, k * 10)
        return r.kept

    a, b = run(99, 200), run(99, 200)
    assert a == b and len(a) == 3 and a[0] == 0
    assert any(run(s, 200) != a for s in range(100, 110))
    assert run(1, 2) == {0: 0, 1: 10}
