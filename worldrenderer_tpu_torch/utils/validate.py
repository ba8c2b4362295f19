"""Correctness gates between kernels (PyTorch counterpart of
``worldrenderer_tpu/utils/validate.py``), run on the card by
``chip_smoke.py`` and on the CPU by the tests.

* :func:`precision_gate` renders the gate scenes through the default fast
  path (``FAST_TPU_CONFIG``, ``fused_pallas``: K1 at the flat path) and
  through ``vpu_pallas`` (K3) and bounds the differences. Both kernels are
  exact fp32 on the port; they differ only by their rounding orders
  (``((a*lx) + (b*ly)) + g`` against ``fma(lx, a, ly*b) + g``), within the
  JAX gate's budget of winner flips at interpenetrating geometry.
* :func:`degenerate_probes` runs the elevation-90 camera (up vector along
  the view direction), a fully off-screen mesh and a camera inside a
  sphere (near-plane crossings everywhere: the clipless setup and the auto
  budgets must give full interior coverage).

On the CPU both paths are the kernels' plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = ["precision_gate", "degenerate_probes"]


def _heightfield(intersect: bool, dev):
    from ..mesh import TexturedMesh, make_grid_mesh

    verts, faces = make_grid_mesh(
        72, extent=1.0, height_fn=lambda x, y: 0.3 * np.sin(3 * x) * np.cos(3 * y)
    )
    if intersect:
        big = np.array(
            [[-4.0, -4.0, -0.5], [4.0, -4.0, -0.5], [0.0, 6.0, -0.5]], np.float32
        )
        nv = verts.shape[0]
        verts = np.concatenate([verts, big], 0)
        faces = np.concatenate([faces, [[nv, nv + 1, nv + 2]]], 0)
    return TexturedMesh(
        v_pos=torch.as_tensor(np.asarray(verts, np.float32), device=dev),
        t_pos_idx=torch.as_tensor(np.asarray(faces, np.int64), device=dev),
    )


def _p999(a: np.ndarray) -> float:
    return float(np.percentile(a, 99.9)) if a.size else 0.0


def _check_scene(name, mesh, dev, n_allowed_flips=8, res=512, quiet=False):
    """K1 against K3 on one scene. Returns (ok, detail line). Winner flips:
    at interpenetrating geometry the two rounding orders can order z apart
    at a handful of pixels, which then show the other triangle; the check
    bounds the p99.9 errors tightly and allows a small budget of such
    pixels. Raw G-buffer z is compared (a normalized depth would rescale a
    whole view for one flip)."""
    from ..camera import get_camera
    from ..ops.gbuffer import rasterize_gbuffer
    from ..ops.rasterize import FAST_TPU_CONFIG
    from ..render import render
    from ..transforms import get_clip_space_position

    cam = get_camera(elevation_deg=35.0, distance=3.0, fovy_deg=50.0,
                     num_views=4, near=0.1, far=10.0, device=dev)
    exact_cfg = FAST_TPU_CONFIG._replace(backend="vpu_pallas",
                                         dot_precision="highest")
    kw = dict(render_attr=False, render_depth=False, render_normal=True,
              device=dev)
    fast = render(mesh, cam, res, res, raster_config=FAST_TPU_CONFIG, **kw)
    exact = render(mesh, cam, res, res, raster_config=exact_cfg, **kw)
    pos_clip = get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    gf = rasterize_gbuffer(pos_clip, mesh.t_pos_idx, None, (res, res),
                           FAST_TPU_CONFIG, device=dev)
    ge = rasterize_gbuffer(pos_clip, mesh.t_pos_idx, None, (res, res),
                           exact_cfg, device=dev)
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    m_f, m_e = host(fast.mask), host(exact.mask)
    mask_diff = int((m_f != m_e).sum())
    m = m_f & m_e
    dn = np.abs(host(fast.normal) - host(exact.normal)).max(-1)[m]
    dp = np.abs(host(fast.pos) - host(exact.pos)).max(-1)[m]
    gm = host(gf.mask) & host(ge.mask)
    dz = np.abs(host(gf.z) - host(ge.z))[gm]
    id_flips = int((host(gf.tri_id) != host(ge.tri_id))[gm].sum())

    # Regression thresholds, not tolerances: a broken kernel gives O(1)
    # errors over whole triangles.
    flips = int((dn > 1e-2).sum())
    edge_budget = max(16, int(1e-4 * m.sum()))
    ok = (
        mask_diff <= edge_budget
        and _p999(dn) < 1e-3
        and _p999(dp) < 2e-2
        and _p999(dz) < 1e-4
        and flips <= n_allowed_flips
        and id_flips <= max(n_allowed_flips * 4, int(1e-4 * gm.sum()))
    )
    line = (
        f"{'PASS' if ok else 'FAIL'} {name}: mask_diff={mask_diff} flips={flips} "
        f"id_flips={id_flips} p99.9 |dn|={_p999(dn):.2e} |dp|={_p999(dp):.2e} "
        f"raw |dz|={_p999(dz):.2e} max |dn|={dn.max() if dn.size else 0:.2e}"
    )
    if not quiet:
        print(line)
    return ok, line


def precision_gate(res: int = 512, quiet: bool = False,
                   device: DeviceLike = None) -> dict:
    """K1 (``fused_pallas``) against K3 (``vpu_pallas``) on the three gate
    scenes: the heightfield, the heightfield with a triangle through it,
    and an icosphere. Returns {"ok": bool, "scenes": [detail lines]}."""
    from ..mesh import TexturedMesh, icosphere

    dev = resolve_device(device)
    verts, faces = icosphere(4)  # 5,120 triangles: the flat path
    sphere = TexturedMesh(
        v_pos=torch.as_tensor(np.asarray(verts, np.float32), device=dev),
        t_pos_idx=torch.as_tensor(np.asarray(faces, np.int64), device=dev),
    )
    results = [
        _check_scene("heightfield", _heightfield(False, dev), dev,
                     n_allowed_flips=0, res=res, quiet=quiet),
        _check_scene("heightfield+intersecting", _heightfield(True, dev), dev,
                     res=res, quiet=quiet),
        _check_scene("icosphere", sphere, dev, n_allowed_flips=4, res=res,
                     quiet=quiet),
    ]
    return {"ok": all(ok for ok, _ in results),
            "scenes": [line for _, line in results]}


def _probe_render(mesh, cam, res, dev):
    from ..ops.rasterize import auto_fast_config
    from ..render import render
    from ..transforms import get_clip_space_position

    pc = get_clip_space_position(mesh.v_pos, cam.mvp_mtx)
    cfg = auto_fast_config(pc, mesh.t_pos_idx, (res, res))
    return render(mesh, cam, res, res, render_attr=False, render_depth=True,
                  render_normal=True, raster_config=cfg, device=dev)


def degenerate_probes(res: int = 256, quiet: bool = False,
                      device: DeviceLike = None) -> dict:
    """Elevation-90 / off-screen / camera-inside-sphere probes.
    Returns {"ok": bool, "probes": [detail lines]}."""
    from ..camera import get_camera
    from ..mesh import TexturedMesh, uv_sphere_mesh

    dev = resolve_device(device)
    mesh = _heightfield(False, dev)
    lines, ok = [], True

    def cam_at(elevation, distance, fovy, azimuth, near):
        return get_camera(elevation_deg=[elevation], distance=[distance],
                          fovy_deg=[fovy], azimuth_deg=[azimuth], near=near,
                          far=10.0, device=dev)

    # 1. elevation 90 (up vector degenerate with the look direction)
    out = _probe_render(mesh, cam_at(90.0, 3.0, 50.0, 0.0, 0.1), res, dev)
    cov = float(out.mask.float().mean())
    fin = bool(torch.isfinite(out.normal).all())
    p_ok = fin and cov > 0.3
    ok &= p_ok
    lines.append(f"{'PASS' if p_ok else 'FAIL'} elev90: cov={cov:.3f} finite={fin}")

    # 2. mesh fully off-screen (clean background, no NaNs)
    far_mesh = mesh._replace(
        v_pos=mesh.v_pos + torch.tensor([100.0, 0.0, 0.0], device=dev))
    out = _probe_render(far_mesh, cam_at(10.0, 3.0, 30.0, 0.0, 0.1), res, dev)
    cov = float(out.mask.float().mean())
    fin = bool(torch.isfinite(out.depth).all())
    p_ok = fin and cov == 0.0
    ok &= p_ok
    lines.append(f"{'PASS' if p_ok else 'FAIL'} offscreen: cov={cov:.3f} finite={fin}")

    # 3. camera inside a sphere (near-plane crossings everywhere)
    sv, sf, _ = uv_sphere_mesh(33, 65)
    sphere = TexturedMesh(
        v_pos=torch.as_tensor(np.asarray(sv, np.float32), device=dev),
        t_pos_idx=torch.as_tensor(np.asarray(sf, np.int64), device=dev),
    )
    out = _probe_render(sphere, cam_at(0.0, 0.2, 80.0, 30.0, 0.05), res, dev)
    cov = float(out.mask.float().mean())
    fin = bool(torch.isfinite(out.normal).all())
    p_ok = fin and cov > 0.95
    ok &= p_ok
    lines.append(f"{'PASS' if p_ok else 'FAIL'} inside-sphere: cov={cov:.3f} "
                 f"finite={fin}")

    if not quiet:
        for line in lines:
            print(line)
    return {"ok": bool(ok), "probes": lines}
