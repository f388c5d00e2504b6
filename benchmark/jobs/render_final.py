"""Closed-loop renders of a configuration with participating media (The
Next Week's final scene): ``jobs/render.py``'s job, checked against the
plain reference for media and every texture kind
(``reference/final.py``), with K1's medium-scatter counter among its
counters and each image's segments as its work, for the metrics that
read them per segment."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

from benchmark.reference import final, tracer

_spec = importlib.util.spec_from_file_location("benchmark_jobs_render_base",
                                               Path(__file__).with_name("render.py"))
_render = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_render)

KIND = _render.KIND


class Job(_render.Job):
    def counters(self) -> dict:
        from raytracing_tpu_torch.ops import megakernel_block

        out = super().counters()
        scatters = getattr(megakernel_block, "medium_scatters", None)
        if scatters is not None:
            out["medium_scatters"] = scatters
        return out

    def work(self) -> dict:
        return {"segments_per_item": [seg for _, seg, _ in self.kept]}

    def reference(self, config_path, device, dtype=torch.float32):
        return reference_pixels(config_path, self.traffic, self.render_seed, self.pixels,
                                device, dtype)


def reference_pixels(config_path, traffic: dict, render_seed: int, pixels, device,
                     dtype=torch.float32):
    """(mean radiance (P, 3), segments (P,)) of the sampled pixels by the
    plain reference for media and textures, as numpy arrays."""
    conf, arrays = final.load_config(config_path)
    sc = final.FinalScene(arrays, device, dtype)
    cam = tracer.Camera(conf["camera"], traffic["image_width"], device, dtype)
    rad, segs, _ = final.render_pixels(sc, cam, torch.as_tensor(pixels),
                                       traffic["samples_per_pixel"], traffic["max_depth"],
                                       render_seed)
    return rad.cpu().numpy(), segs.cpu().numpy()
