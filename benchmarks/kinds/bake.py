"""Request kind ``bake``: a closed loop of one client. Request k bakes
image set k mod ``image_pool`` (one image per camera of the mix: the mesh
under a smooth-noise texture drawn from the seed, rendered in set-up by the
benchmark's own plain renderer) into the configuration's texture through
``worldrenderer_tpu_torch.baking.camera_projection`` with the
configuration's keywords, and waits for the card. A request's work is one
bake.

The numbers that decide ``correct`` (``counts``), over all kept bakes:

* ``mask_mismatch_share``: texels whose validity differs, over all texels;
* ``texel_off_share``: texels whose largest channel difference exceeds
  ``tolerance``, over all texels.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from harness import scenes
from harness.traffic import Driver, generator, make_texture


class Bake(Driver):
    work_unit = "bakes"

    def build(self) -> None:
        cfg, dev, pt = self.config, self.device, self.pt
        verts, faces, uv = scenes.make_scene(cfg["scene"])
        self.height, self.width = self.mix["image_size"]
        cams = scenes.request_cameras(self.mix["cameras"], self.height, self.width)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        tri = torch.as_tensor(faces, device=dev)
        self.scene = {"v_pos": f32(verts), "tri": tri, "t_tex": tri,
                      "v_tex": f32(uv)}
        self.cams = {k: f32(v) for k, v in cams.items()}
        self.mesh = pt.mesh_from_arrays(verts, faces, v_tex=uv, t_tex_idx=faces,
                                        device=dev)
        self.cam = pt.camera_from_arrays(
            cams["c2w"], cams["w2c"], cams["proj"], cams["mvp"], cams["cam_pos"],
            device=dev)
        bc = cfg["bake"]
        self.uv_size = bc["uv_size"]
        self.kw = dict(bc["keywords"])
        if "raster" in bc or "raster_backend" in cfg:
            self.kw["raster_config"] = self.with_backend(
                pt.config_from_dict(bc.get("raster", {})))
        if self.kw.pop("view_weight_ones", False):
            self.kw["uv_exp_blend_view_weight"] = torch.ones(
                len(self.cam), device=dev)

    def reseed(self, seed: int) -> None:
        from reference.render import textured_views

        tex = make_texture(self.config["texture"], seed, self.device)
        self.scene["texture"] = tex
        self.mesh = self.mesh._replace(texture=tex.clone())
        m = self.mix
        s = m["image_texture_size"]
        # The views show the mesh under a texture of their own drawn from
        # the seed, as generated views show one asset: they agree where
        # they overlap.
        src = scenes.smooth_noise(generator(seed + 1, self.device),
                                  (m["image_pool"], s, s, 3),
                                  m["image_noise_cell"], 0.05, 0.95, self.device)
        scene = {k: self.scene[k] for k in ("v_pos", "tri", "v_tex")}
        self.images = torch.stack([
            textured_views(scene, src[p], self.cams, self.height, self.width,
                           m["image_background"])
            for p in range(m["image_pool"])])

    def request(self, k: int):
        out = self._bake(self.images[k % self.mix["image_pool"]])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def _bake(self, images):
        """The program's path: ``camera_projection`` as ``TexturePipeline``
        calls it for its rgb modality."""
        from worldrenderer_tpu_torch.baking import camera_projection

        out = camera_projection(images, self.mesh, cam=self.cam,
                                uv_size=self.uv_size, device=self.device,
                                **self.kw)
        return out.uv_proj, out.uv_proj_mask

    def release(self) -> None:
        self.mesh = self.cam = None

    def reference(self, k: int, tf32: bool = False,
                  dtype: torch.dtype = torch.float64) -> Dict[str, torch.Tensor]:
        from reference.bake import bake

        images = self.images[k % self.mix["image_pool"]]
        kw = {k: v for k, v in self.kw.items() if k != "raster_config"}
        if "uv_exp_blend_view_weight" in kw:
            kw["uv_exp_blend_view_weight"] = kw["uv_exp_blend_view_weight"].cpu().numpy()
        uv_proj, mask = bake(self.scene, self.cams, images, self.uv_size, kw,
                             tf32=tf32, dtype=dtype)
        return {"uv_proj": uv_proj, "uv_proj_mask": mask}

    def program_outputs(self, kept) -> Dict[str, torch.Tensor]:
        return {"uv_proj": kept[0], "uv_proj_mask": kept[1]}

    def work(self, k: int) -> int:
        return 1


DRIVER = Bake


def counts(prog: Dict, ref: Dict, tol: Dict) -> Dict[str, Tuple]:
    """Per number, ("share", count, base) or ("max", value)."""
    pm, rm = prog["uv_proj_mask"].bool(), ref["uv_proj_mask"].bool()
    d = (prog["uv_proj"].float() - ref["uv_proj"].float()).abs().amax(dim=-1)
    return {"mask_mismatch_share": ("share", float((pm != rm).sum()), float(pm.numel())),
            "texel_off_share": ("share", float((d > tol.get("texel_off_share", 0.0)).sum()),
                                float(d.numel()))}


def spread(prog: Dict, ref: Dict, quantiles) -> Dict[str, List[float]]:
    """``quantiles`` of the texels' largest channel differences."""
    d = (prog["uv_proj"].float() - ref["uv_proj"].float()).abs().amax(-1)
    return {"uv_proj": quantiles(d)}


TRIAL_TOLERANCES = {"texel_off_share": (0.001, 0.003, 0.01, 0.03)}
