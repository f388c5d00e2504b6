"""Closed-loop renders: one image after another of the configuration's
scene through ``Renderer(cfg, **traffic["renderer"]).render(scene,
seed=...)``, each image copied to the host (``RenderResult.radiance``).

Every image of a run renders the same camera samples, keyed by the render
seed drawn from ``--seed``. The check compares, for every image of the
window, ``check_pixels`` pixels spread evenly over the image
(``compare.pixel_sample``, its offset drawn from ``--seed``) with the
plain reference's mean radiance over every sample of those pixels, and
the image's segment count with the reference's estimate from them.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.common import compare
from benchmark.reference import tracer

KIND = "render"


class Job:
    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        from raytracing_tpu_torch import Renderer
        from raytracing_tpu_torch.models.scenes import build

        self.traffic = traffic
        self.render_seed = compare.render_seed(seed)
        self.scene, self.cfg = build(conf["port_scene"], device=torch.device(device),
                                     image_width=traffic["image_width"],
                                     samples_per_pixel=traffic["samples_per_pixel"],
                                     max_depth=traffic["max_depth"])
        self.renderer = Renderer(self.cfg, **traffic.get("renderer", {}))
        self.n_pixels = self.cfg.n_pixels
        self.samples_per_item = self.n_pixels * self.cfg.samples_per_pixel
        self.pixels = compare.pixel_sample(seed, self.n_pixels, traffic["check_pixels"])
        self.kept = []  # per image: (radiance at the sampled pixels, segments, ok)

    def warm_up(self):
        """One image: builds the kernels, captures the launch program."""
        self.item()

    @property
    def capture_seconds(self) -> float:
        prog = self.renderer.programs.program
        return float(prog.capture_seconds) if prog is not None else 0.0

    def counters(self) -> dict:
        from raytracing_tpu_torch.ops import megakernel_block

        return {"k1_launches": megakernel_block.launches}

    def item(self):
        return self.renderer.render(self.scene, seed=self.render_seed)

    def keep(self, res) -> None:
        img = np.asarray(res.radiance, np.float32).reshape(-1, 3)
        self.kept.append((img[self.pixels], int(res.segments), res.ok is not False))

    def work(self) -> dict:
        return {}

    def release(self) -> None:
        """Drops the program's state (scene, renderer, graphs) before the
        reference runs."""
        self.scene = self.renderer = None

    def reference(self, config_path, device, dtype=torch.float32):
        return reference_pixels(config_path, self.traffic, self.render_seed, self.pixels,
                                device, dtype)

    def check(self, config_path, device, ref=None) -> list:
        """The compared numbers of every kept image against the plain
        reference's pixels (``ref``, computed here if not given)."""
        ref = ref if ref is not None else self.reference(config_path, device)
        return [compare.render_numbers(px, seg, ok, *ref, self.n_pixels)
                for px, seg, ok in self.kept]

    def control_numbers(self, low, ref) -> dict:
        """The numbers of a lower-precision reference ``low`` put in the
        program's place: its image's segments estimated from its pixels."""
        est = float(low[1].astype(np.float64).mean()) * self.n_pixels
        return compare.render_numbers(low[0], est, True, ref[0], ref[1], self.n_pixels)


def reference_pixels(config_path, traffic: dict, render_seed: int, pixels, device,
                     dtype=torch.float32):
    """(mean radiance (P, 3), segments (P,)) of the sampled pixels by the
    plain reference, as numpy arrays."""
    conf, arrays = tracer.load_config(config_path)
    sc = tracer.Scene(arrays, device, dtype)
    cam = tracer.Camera(conf["camera"], traffic["image_width"], device, dtype)
    rad, segs = tracer.render_pixels(sc, cam, torch.as_tensor(pixels), traffic["samples_per_pixel"],
                                     traffic["max_depth"], render_seed)
    return rad.cpu().numpy(), segs.cpu().numpy()
