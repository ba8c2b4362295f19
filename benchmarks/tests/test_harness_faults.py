"""A whole run on the CPU at tiny sizes, the look for a card skipped, with
the timed path broken underneath: ``correct`` comes out false for each
fault a cell can have."""

import time

import pytest
import torch

import tinybench  # noqa: F401
from harness.cell import run_cell


def _run(manifest, workload, hook=None):
    return run_cell(manifest, manifest.workload(workload), 2**32 + 17, 0.5,
                    False, "cpu", time.perf_counter(), driver_hook=hook)


def _render_fault(kind):
    def hook(driver):
        sound = driver._render

        def broken(cam):
            n = len(cam)
            if kind == "half_batch":
                # Half of the chunk left out, the rest repeated in its place.
                rgb, depth, normal, mask = sound(cam[: n // 2])
                return tuple(torch.cat([x, x]) for x in (rgb, depth, normal, mask))
            if kind == "depth_wrong_view":  # the last frame's depth of the first
                rgb, depth, normal, mask = sound(cam)
                depth = depth.clone()
                depth[-1] = sound(cam[:1])[1][0]
                return rgb, depth, normal, mask
            rgb, depth, normal, mask = sound(cam)
            if kind == "altered":  # one frame's colour channels swapped
                rgb = rgb.clone()
                rgb[-1] = torch.flip(rgb[-1], dims=[-1])
            if kind == "depth_zero":
                depth = torch.where(mask, 0.0, depth)
            if kind == "depth_scaled":  # one frame's depth off by 1e-4
                depth = depth.clone()
                depth[-1] = depth[-1] * (1.0 + 1e-4)
            return rgb, depth, normal, mask

        driver._render = broken
    return hook


def _bake_fault(kind):
    def hook(driver):
        sound = driver._bake

        def broken(images):
            if kind == "unchanged":
                # The step hands back the texture it was given.
                return driver.mesh.texture.clone(), torch.zeros(
                    driver.mesh.texture.shape[:2], dtype=torch.bool)
            if kind == "half_batch":
                cam, n = driver.cam, images.shape[0]
                driver.cam = cam[: n // 2]
                kw = dict(driver.kw)
                if "uv_exp_blend_view_weight" in kw:
                    driver.kw["uv_exp_blend_view_weight"] = kw["uv_exp_blend_view_weight"][: n // 2]
                try:
                    return sound(images[: n // 2])
                finally:
                    driver.cam, driver.kw = cam, kw
            uv, mask = sound(images)
            if kind == "validity":  # an eighth of the rows' validity inverted
                mask = mask.clone()
                mask[: mask.shape[0] // 8] ^= True
                return uv, mask
            # the texture's colour channels swapped
            return torch.flip(uv, dims=[-1]), mask

        driver._bake = broken
    return hook


@pytest.mark.parametrize("kind", ["altered", "half_batch", "depth_zero",
                                  "depth_scaled", "depth_wrong_view"])
def test_a_broken_render_is_not_correct(tiny_manifest, kind):
    res = _run(tiny_manifest, "terrain-rerender-classic", _render_fault(kind))
    assert res["correct"] is False
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("kind", ["altered", "half_batch", "unchanged",
                                  "validity"])
def test_a_broken_bake_is_not_correct(tiny_manifest, kind):
    res = _run(tiny_manifest, "tex4k-bake-classic", _bake_fault(kind))
    assert res["correct"] is False


def test_a_request_that_raises_is_counted_and_not_correct(tiny_manifest):
    def hook(driver):
        sound, calls = driver._render, []

        def broken(cam):
            calls.append(1)
            if len(calls) > 1:  # the warm-up request in set-up succeeds
                raise RuntimeError("out of memory")
            return sound(cam)
        driver._render = broken

    res = _run(tiny_manifest, "terrain-rerender-classic", hook)
    assert res["correct"] is False and res["failed"] == res["attempted"] > 0


def test_the_result_line_has_the_contracts_keys(tiny_manifest):
    res = _run(tiny_manifest, "terrain-rerender-classic")
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device",
                         "checks"]
    assert set(res["metrics"]) == {"frames_per_s", "chunk_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
