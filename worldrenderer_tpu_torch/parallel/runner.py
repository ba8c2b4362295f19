"""Dataset-scale render sweep runner (PyTorch counterpart of
``worldrenderer_tpu/parallel/runner.py``): many (mesh, trajectory) jobs
over a device mesh with size bucketing, async host IO, and resume.

* meshes are padded to size buckets (degenerate faces on vertex 0, which
  the rasterizer culls), so jobs of one bucket share one set of shapes;
* the view axis is split over the mesh (``render_views_sharded``), padded
  to the mesh size by repeating view 0;
* PNG and 16-bit depth writes run on a host thread pool, overlapping the
  next job's renders;
* ``sweep_progress.json`` records finished jobs (written by the main
  process only), and a new runner on the same directory skips them.
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..camera import Camera
from ..mesh import TexturedMesh
from ..utils.logging import get_logger
from .device_mesh import DeviceMesh, make_device_mesh
from .dist import is_main_process
from .sweep import render_views_sharded

logger = get_logger(__name__)

__all__ = ["RenderJob", "SweepRunner", "pad_mesh_to_bucket"]


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(max(n, 1))))


def pad_mesh_to_bucket(
    mesh: TexturedMesh,
    vertex_buckets: Sequence[int] = (1 << 12, 1 << 14, 1 << 16, 1 << 18),
    face_buckets: Sequence[int] = (1 << 12, 1 << 14, 1 << 16, 1 << 18),
) -> TexturedMesh:
    """Pad the vertex and face buffers up to bucket sizes: zero vertices,
    and faces that reference vertex 0 three times (zero area, culled by
    the rasterizer's setup)."""
    bv = _next_bucket(mesh.num_vertices, vertex_buckets)
    bf = _next_bucket(mesh.num_faces, face_buckets)

    def pad_rows(a, n, fill=0):
        if a is None or a.shape[0] >= n:
            return a
        return torch.cat([a, a.new_full((n - a.shape[0], *a.shape[1:]), fill)])

    out = mesh._replace(
        v_pos=pad_rows(mesh.v_pos, bv),
        t_pos_idx=pad_rows(mesh.t_pos_idx, bf),
        v_tex=pad_rows(mesh.v_tex, bv),
        t_tex_idx=pad_rows(mesh.t_tex_idx, bf),
        v_nrm=pad_rows(mesh.v_nrm, bv),
        v_tang=pad_rows(mesh.v_tang, bv),
    )
    if mesh.stitched_v_pos is not None:
        out = out._replace(
            stitched_v_pos=pad_rows(mesh.stitched_v_pos, bv),
            stitched_t_pos_idx=pad_rows(mesh.stitched_t_pos_idx, bf),
        )
    return out


@dataclass
class RenderJob:
    """One sweep unit: a mesh + camera trajectory to render."""

    name: str
    mesh: TexturedMesh
    cam: Camera
    height: int = 512
    width: int = 512
    render_kwargs: dict = field(default_factory=dict)


class SweepRunner:
    """Run many render jobs across a device mesh (every local card by
    default) with async IO."""

    def __init__(
        self,
        output_dir: str,
        device_mesh: Optional[DeviceMesh] = None,
        io_workers: int = 8,
        bucket_meshes: bool = True,
    ):
        self.output_dir = output_dir
        self.device_mesh = device_mesh or make_device_mesh()
        self.executor = ThreadPoolExecutor(max_workers=io_workers)
        self.bucket_meshes = bucket_meshes
        self._progress_path = os.path.join(output_dir, "sweep_progress.json")
        self._done: set = set()
        self._lock = threading.Lock()
        os.makedirs(output_dir, exist_ok=True)
        self._load_progress()

    # -- progress / resume --------------------------------------------------

    def _load_progress(self) -> None:
        if os.path.exists(self._progress_path):
            try:
                with open(self._progress_path) as f:
                    self._done = set(json.load(f))
                logger.info(f"Resuming sweep: {len(self._done)} jobs already done")
            except (OSError, json.JSONDecodeError):
                self._done = set()

    def _mark_done(self, name: str) -> None:
        with self._lock:
            self._done.add(name)
            if is_main_process():
                with open(self._progress_path, "w") as f:
                    json.dump(sorted(self._done), f)

    # -- IO ------------------------------------------------------------------

    def _save_outputs(self, job: RenderJob, out_np: dict) -> None:
        from ..scene.video import save_depth_frames_16bit, save_frames

        job_dir = os.path.join(self.output_dir, job.name)
        if "attr" in out_np:
            save_frames(out_np["attr"], os.path.join(job_dir, "rgb"), "rgb")
        if "mask" in out_np:
            save_frames(out_np["mask"], os.path.join(job_dir, "mask"), "mask")
        if "depth" in out_np:
            save_depth_frames_16bit(
                out_np["depth"], os.path.join(job_dir, "depth"), "depth"
            )
        if "normal" in out_np:
            save_frames(
                np.clip(out_np["normal"] * 0.5 + 0.5, 0, 1),
                os.path.join(job_dir, "normal"),
                "normal",
            )
        self._mark_done(job.name)

    # -- main ----------------------------------------------------------------

    def run(self, jobs: List[RenderJob], save: bool = True) -> List[Optional[dict]]:
        """Render all jobs; returns per-job dicts of numpy arrays (None for
        a skipped job). Host IO for job i overlaps the renders of job i+1."""
        n_dev = self.device_mesh.size
        futures = []
        results: List[Optional[dict]] = []
        for job in jobs:
            if job.name in self._done:
                logger.info(f"skip {job.name} (done)")
                results.append(None)
                continue
            mesh = pad_mesh_to_bucket(job.mesh) if self.bucket_meshes else job.mesh
            n_views = len(job.cam)
            pad_views = (-n_views) % n_dev
            cam = job.cam
            if pad_views:
                idx = torch.cat([torch.arange(n_views),
                                 torch.zeros(pad_views, dtype=torch.long)])
                cam = cam[idx]
            out = render_views_sharded(mesh, cam, job.height, job.width,
                                       self.device_mesh, **job.render_kwargs)
            out_np = {k: v[:n_views].cpu().numpy()
                      for k, v in out._asdict().items() if v is not None}
            results.append(out_np)
            if save:
                futures.append(self.executor.submit(self._save_outputs, job, out_np))

        for f in futures:
            f.result()
        return results
