"""The plain reference against the port's own CPU run (``device="cpu"``,
the kernels' plain versions) at tiny sizes. The test imports the port;
the reference does not."""

import copy

import torch

import tinybench  # noqa: F401
from harness.readings import quantiles
from harness.traffic import driver_for


DEPTH_Q99, DEPTH_MAX = 1e-7, 5e-7


def _pair(manifest, workload, k=0, seed=3, config=None):
    """``workload``: a cell's name, or a (configuration, mix) pair."""
    cell = (manifest.workload(workload) if isinstance(workload, str)
            else dict(zip(("config", "traffic"), workload)))
    mix = manifest.traffic(cell["traffic"])
    cfg = copy.deepcopy(manifest.config(cell["config"]))
    cfg.update(config or {})
    d = driver_for(manifest, cfg, mix, "cpu")
    d.build()
    d.reseed(seed)
    prog, ref = d.program_outputs(d.request(k)), d.reference(k)
    return manifest.kind(mix["kind"]).spread(prog, ref, quantiles), prog, ref


def test_render_matches_the_reference(tiny_manifest):
    s, prog, ref = _pair(tiny_manifest, "terrain-rerender-classic", k=1)
    assert torch.equal(prog["mask"], ref["mask"])
    # quantiles 0.5, 0.9, 0.99, 0.999, 1 of each channel's differences
    assert s["rgb"][2] < 2e-4 and s["rgb"][4] < 2e-3
    assert s["normal"][2] < 2e-5 and s["normal"][4] < 2e-4
    # Depth, 1/65.535 of the view distance, from barycentric positions.
    assert s["depth"][2] < DEPTH_Q99 and s["depth"][4] < DEPTH_MAX
    assert bool(prog["mask"].any()) and not bool(prog["mask"].all())


def test_the_fused_branch_depth_is_coarser(tiny_manifest):
    # The witness behind the classic stand-in: the default fused branch
    # unprojects K1's fp32 depth plane, whose error the classic branch's
    # barycentric positions do not carry.
    fused, _, _ = _pair(tiny_manifest, "terrain-rerender-classic", k=1,
                        config={"raster_backend": "fused_pallas"})
    classic, _, _ = _pair(tiny_manifest, "terrain-rerender-classic", k=1)
    assert fused["depth"][4] > 10 * classic["depth"][4]


def test_a_six_view_bake_matches_the_reference(tiny_manifest):
    q, prog, ref = _pair(tiny_manifest, "tex4k-bake-classic")
    assert torch.equal(prog["uv_proj_mask"], ref["uv_proj_mask"])
    assert float(ref["uv_proj_mask"].float().mean()) > 0.3
    assert q["uv_proj"][2] < 1e-5


def test_a_keyframe_bake_on_the_classic_path_matches_the_reference(tiny_manifest):
    # The keyframe mix has no cell: at its own size (1M triangles, 24
    # views, 2048^2 texels) the program's validity differs from the
    # reference's on 0.22% of texels, the reference in float32 on 0.001%.
    # At this size both agree. The default fused branch unprojects an fp32
    # depth plane, whose error flips the bake's 1e-3 reprojection bound on
    # some texels even here.
    q, prog, ref = _pair(tiny_manifest, ("wr-terrain-1m-classic", "keyframe-bake"))
    flips = float((prog["uv_proj_mask"] != ref["uv_proj_mask"]).float().mean())
    assert flips < 1e-3
    assert float(ref["uv_proj_mask"].float().mean()) > 0.3
    assert q["uv_proj"][2] < 1e-4
