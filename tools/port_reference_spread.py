"""How far the PyTorch port's workload-1 render is from the JAX package's,
on the CPU, with the reference as users run it (jitted) and op by op.

Workload 1: ``render()`` of the 3,968-triangle UV sphere
``uv_sphere_mesh(32, 65)`` at 512², views 0 and 3 of the six orbit views of
``bench.py:597``, mask, position, depth and normals, for each backend. The
port runs with ``device="cpu"``. For each backend it prints the mask pixels
that differ and, over the pixels both masks cover, the largest absolute
difference of positions, depth and normals and the pixels that differ by
more than the tolerances the port is held to op by op (``ATOL``), against

  * ``jitted``: ``worldrenderer_tpu.render`` as users call it;
  * ``op_by_op``: the same under ``jax.disable_jit()`` (its Pallas kernels
    still jitted), with the clip transform on the sphere's own 2,080
    vertices, the reference ``tests/test_torch_port_tiles.py`` pads to 4,096;
  * ``reference_self``: ``jitted`` against ``op_by_op``, the JAX package
    against itself, for scale.

Run from the repository root: ``JAX_PLATFORMS=cpu python
tools/port_reference_spread.py``. It prints one JSON object.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import worldrenderer_tpu as wr  # noqa: E402
import worldrenderer_tpu.ops.gbuffer_pallas  # noqa: E402,F401
import worldrenderer_tpu.ops.rasterize_pallas  # noqa: E402,F401
from worldrenderer_tpu.mesh import uv_sphere_mesh  # noqa: E402

import worldrenderer_tpu_torch as pt  # noqa: E402

CAM_FIELDS = ("c2w", "w2c", "proj_mtx", "mvp_mtx", "cam_pos")
RENDER_KW = dict(render_attr=False, render_depth=True, render_normal=True)
BACKENDS = ("fused_pallas", "vpu_pallas", "pallas")


def sphere_scene():
    """Workload 1's mesh and views 0 and 3, for both packages."""
    verts, faces, _ = uv_sphere_mesh(32, 65)
    verts, faces = verts.astype(np.float32), faces.astype(np.int32)
    jcam = wr.get_camera(elevation_deg=20.0, distance=2.7, fovy_deg=40.0,
                         num_views=6, near=0.1, far=10.0)[[0, 3]]
    pcam = pt.camera_from_arrays(*(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS),
                                 device="cpu")
    jmesh = wr.TexturedMesh(v_pos=jnp.asarray(verts), t_pos_idx=jnp.asarray(faces))
    return jmesh, jcam, pt.mesh_from_arrays(verts, faces, device="cpu"), pcam


@contextlib.contextmanager
def op_by_op():
    """The JAX package op by op, its Pallas kernels jitted."""
    gp = sys.modules["worldrenderer_tpu.ops.gbuffer_pallas"]
    rp = sys.modules["worldrenderer_tpu.ops.rasterize_pallas"]
    with contextlib.ExitStack() as stack:
        for mod, name in ((gp, "zattr_tiles_vpu"), (gp, "zattr_tiles_pallas"),
                          (gp, "gbuffer_tiles_dma"), (rp, "raster_zid_tiles_pallas")):
            kernel = getattr(mod, name)

            def jitted(*args, _kernel=kernel, **kw):
                with jax.disable_jit(False):
                    return _kernel(*args, **kw)

            stack.enter_context(mock.patch.object(mod, name, jitted))
        stack.enter_context(jax.disable_jit())
        yield


# The tolerances the port is held to against the padded op-by-op reference.
ATOL = {"pos": 1e-5, "depth": 1e-5, "normal": 5e-4}


def spread(out, ref) -> dict:
    """Mask pixels that differ; where both cover, each field's max abs
    difference and the pixels that differ by more than its ATOL."""
    om, rm = np.asarray(out.mask), np.asarray(ref.mask)
    both = om & rm
    res = {"foreground": int(rm.sum()), "mask_diff": int((om != rm).sum())}
    for f, atol in ATOL.items():
        d = np.abs(np.asarray(getattr(out, f)) - np.asarray(getattr(ref, f)))[both]
        if d.ndim > 1:
            d = d.max(axis=-1)
        res[f] = float(d.max())
        res[f"{f}_px_over_atol"] = int((d > atol).sum())
    return res


def main() -> None:
    jmesh, jcam, pmesh, pcam = sphere_scene()
    result = {}
    for backend in BACKENDS:
        out = pt.render(pmesh, pcam, 512, 512, device="cpu",
                        raster_config=pt.RasterizerConfig(backend=backend),
                        **RENDER_KW)
        cfg = wr.RasterizerConfig(backend=backend)
        jitted = wr.render(jmesh, jcam, 512, 512, raster_config=cfg, **RENDER_KW)
        with op_by_op():
            ref = wr.render(jmesh, jcam, 512, 512, raster_config=cfg, **RENDER_KW)
        result[backend] = {"jitted": spread(out, jitted),
                           "op_by_op": spread(out, ref),
                           "reference_self": spread(jitted, ref)}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
