"""Request kind ``render_path``: a closed loop of one client. Request k
renders the ``frames_per_request`` frames of the camera path that follow
frame ``start + k * frames_per_request`` (the path wraps; ``start`` is
drawn from the seed) through ``worldrenderer_tpu_torch.render`` with
``project_and_render``'s ``render_batch`` keywords, and copies rgb, depth,
normal and mask to the host. A request's work is its frames.

The numbers that decide ``correct`` (``counts``), each the largest over
the kept frames, so that one wrong frame shows whole:

* ``mask_mismatch_share``: pixels whose mask differs, over the frame's
  pixels;
* ``rgb_off_share``, ``normal_off_share``, ``depth_off_share``: pixels
  that both sides cover where the channel's largest absolute difference
  exceeds its ``tolerance``, over the pixels both cover;
* ``depth_bias``: the largest, over frames, of the mean signed depth
  difference over the pixels both cover (depth in the frames' units);
* ``depth_block_bias``: the same over 32 x 32-pixel blocks of which both
  sides cover at least half, the largest over blocks and frames.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import torch

from harness import scenes
from harness.traffic import Driver, make_texture


class RenderPath(Driver):
    work_unit = "frames"

    def build(self) -> None:
        cfg, dev, pt = self.config, self.device, self.pt
        rc = cfg["render"]
        self.height, self.width = rc["height"], rc["width"]
        verts, faces, uv = scenes.make_scene(cfg["scene"])
        cams = scenes.request_cameras(self.mix["cameras"], self.height, self.width)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        self.scene = {"v_pos": f32(verts),
                      "tri": torch.as_tensor(faces, device=dev),
                      "v_tex": f32(uv)}
        self.cams = {k: f32(v) for k, v in cams.items()}
        self.n_frames = self.cams["mvp"].shape[0]
        self.per_request = self.mix["frames_per_request"]
        self.mesh = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                                        device=dev)
        self.cam_all = pt.camera_from_arrays(
            cams["c2w"], cams["w2c"], cams["proj"], cams["mvp"], cams["cam_pos"],
            device=dev)
        if rc["raster"] == "fast":
            from worldrenderer_tpu_torch.ops.rasterize import (FAST_TPU_CONFIG,
                                                                auto_fast_config)

            pos_clip = pt.get_clip_space_position(self.mesh.v_pos, self.cam_all.mvp_mtx)
            self.raster_config = auto_fast_config(
                pos_clip, self.mesh.t_pos_idx, (self.height, self.width),
                base=FAST_TPU_CONFIG, backface_cull=rc["backface_cull"])
            del pos_clip
        else:
            self.raster_config = pt.RasterizerConfig(backface_cull=rc["backface_cull"])
        self.raster_config = self.with_backend(self.raster_config)
        self.depth_norm = pt.SimpleNormalization(
            scale=rc["depth_scale"], offset=0.0, clamp=True, bg_value=1.0)

    def reseed(self, seed: int) -> None:
        tex = make_texture(self.config["texture"], seed, self.device)
        self.scene["texture"] = tex
        self.mesh = self.mesh._replace(texture=tex.clone())
        self.start = random.Random(seed).randrange(self.n_frames)

    def frames(self, k: int) -> List[int]:
        first = self.start + k * self.per_request
        return [(first + j) % self.n_frames for j in range(self.per_request)]

    def request(self, k: int):
        idx = torch.as_tensor(self.frames(k), device=self.device)
        outs = self._render(self.cam_all[idx])
        return tuple(o.cpu() for o in outs)

    def _render(self, cam):
        """``project_and_render``'s ``render_batch``: the program's path."""
        rc = self.config["render"]
        out = self.pt.render(
            self.mesh, cam, self.height, self.width, render_attr=True,
            render_depth=True, render_normal=True,
            depth_normalization_strategy=self.depth_norm,
            attr_background=rc["attr_background"],
            raster_config=self.raster_config, device=self.device)
        rgb, geo_mask = out.attr, out.mask
        tex_mask = (rgb.abs().sum(-1) > 1e-6) & geo_mask
        rgb = torch.where(tex_mask[..., None], rgb, 0.0)
        depth = torch.where(geo_mask, out.depth, 1.0)
        return rgb, depth, out.normal, tex_mask

    def release(self) -> None:
        self.mesh = self.cam_all = None

    def reference(self, k: int, tf32: bool = False,
                  dtype: torch.dtype = torch.float64) -> Dict[str, torch.Tensor]:
        from reference.render import render_frames

        idx = torch.as_tensor(self.frames(k), device=self.device)
        cams = {"mvp": self.cams["mvp"][idx], "w2c": self.cams["w2c"][idx]}
        rc = self.config["render"]
        return render_frames(self.scene, cams, self.height, self.width,
                             rc["depth_scale"], rc["attr_background"],
                             cull=rc["backface_cull"], tf32=tf32, dtype=dtype)

    def program_outputs(self, kept) -> Dict[str, torch.Tensor]:
        rgb, depth, normal, mask = (o.to(self.device) for o in kept)
        return {"rgb": rgb, "depth": depth, "normal": normal, "mask": mask}

    def work(self, k: int) -> int:
        return self.per_request


DRIVER = RenderPath


def _frame_share(hit: torch.Tensor, base: torch.Tensor) -> float:
    """Largest per-frame share of (V, H, W) ``hit`` over ``base``."""
    n = base.sum(dim=(1, 2)).clamp(min=1).double()
    return float((hit.sum(dim=(1, 2)).double() / n).max())


BLOCK = 32


def _block_bias(diff: torch.Tensor, both: torch.Tensor, b: int) -> float:
    """Largest |mean of ``diff``| over the b x b blocks of (V, H, W) maps
    in which ``both`` holds at half of the pixels or more."""
    v, h, w = diff.shape
    hh, ww = h // b * b, w // b * b
    d = diff[:, :hh, :ww].reshape(v, hh // b, b, ww // b, b).sum(dim=(2, 4))
    n = both[:, :hh, :ww].reshape(v, hh // b, b, ww // b, b).sum(dim=(2, 4))
    full = n >= b * b // 2
    if not bool(full.any()):
        return 0.0
    return float((d[full] / n[full]).abs().max())


def counts(prog: Dict, ref: Dict, tol: Dict) -> Dict[str, Tuple]:
    """Per number, ("share", count, base) or ("max", value)."""
    pm, rm = prog["mask"], ref["mask"]
    both = pm & rm
    out = {"mask_mismatch_share": ("max", _frame_share(pm != rm, torch.ones_like(pm)))}
    for name, key in (("rgb_off_share", "rgb"), ("normal_off_share", "normal"),
                      ("depth_off_share", "depth")):
        d = (prog[key].float() - ref[key].float()).abs()
        if d.ndim == 4:
            d = d.amax(dim=-1)
        out[name] = ("max", _frame_share(both & (d > tol.get(name, 0.0)), both))
    dd = torch.where(both, prog["depth"].double() - ref["depth"].double(), 0.0)
    per_frame = dd.sum(dim=(1, 2)) / both.sum(dim=(1, 2)).clamp(min=1)
    out["depth_bias"] = ("max", float(per_frame.abs().max()))
    out["depth_block_bias"] = ("max", _block_bias(dd, both, BLOCK))
    return out


def spread(prog: Dict, ref: Dict, quantiles) -> Dict[str, List[float]]:
    """``quantiles`` of each channel's absolute differences where both
    sides cover."""
    both = prog["mask"] & ref["mask"]
    out = {}
    for k in ("rgb", "depth", "normal"):
        d = (prog[k].float() - ref[k].float()).abs()
        if d.ndim == 4:
            d = d.amax(-1)
        out[k] = quantiles(d[both])
    return out


# The tolerances at which readings also take a share, to choose one that
# separates the program from the control. Depth is in the frames' units:
# 1/65535 is one step of the 16-bit depth that project_and_render writes.
LSB16 = 1.0 / 65535
TRIAL_TOLERANCES = {
    "rgb_off_share": (0.01, 0.02, 0.03, 0.05),
    "normal_off_share": (1e-4, 3e-4, 1e-3),
    "depth_off_share": (0.05 * LSB16, 0.1 * LSB16, 0.25 * LSB16, LSB16),
}


def trace_counts(driver: RenderPath, records) -> Dict:
    """The flat-path tile kernel's (K1's) least work for the traced
    requests, counted by the benchmark (``harness/roofline.py``)."""
    from harness.roofline import k1_entries

    cfg = driver.raster_config
    per_frame = {}
    entries = 0
    for r in records:
        if r.failed:
            continue
        for f in driver.frames(r.k):
            if f not in per_frame:
                per_frame[f] = k1_entries(driver.scene, driver.cams["mvp"][f],
                                          driver.height, driver.width, cfg)
            entries += per_frame[f]
    fused = cfg.backend in ("auto", "fused_pallas", "fused_xla")
    return {"k1": {"entries": entries,
                   "frames": sum(r.work for r in records if not r.failed),
                   "height": driver.height, "width": driver.width,
                   "tile_h": cfg.tile_h, "tile_w": cfg.tile_w,
                   # Planes K1 writes besides z and id: the fused branch's
                   # normal (3) and (u, v) (2); the classic branch's
                   # barycentrics (2).
                   "n_attr": 5 if fused else 2}}
