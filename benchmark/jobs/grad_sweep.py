"""Closed-loop gradient sweeps: the MSE of each chunk's image against a
black target, differentiated with respect to the sphere centres and the
texture colours, summed over every chunk of ``spp_chunk`` samples, each
sweep's loss, gradients, segments and plan flag copied to the host in one
copy. The entry is the port's ``bench._fwd_bwd_setup``: its ``plan()``
in set-up, then ``sweep(fused=True)`` once a sweep.

The scene is the one that entry builds (``bouncing_spheres``). Every
sweep of a run traces the same samples, keyed by the render seed drawn
from ``--seed``; the check compares every sweep of the window with one
plain-reference sweep over all of them.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.common import compare, roofline
from benchmark.reference import tracer

KIND = "grad"


class Job:
    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        from raytracing_tpu_torch import bench

        if conf["port_scene"] != "bouncing_spheres":
            raise ValueError("the port's gradient-sweep entry builds bouncing_spheres only, "
                             f"not {conf['port_scene']}")
        self.conf, self.traffic, self.device = conf, traffic, torch.device(device)
        self.render_seed = compare.render_seed(seed)
        t = traffic
        self.s = bench._fwd_bwd_setup(width=t["image_width"], spp=t["samples_per_pixel"],
                                      max_depth=t["max_depth"], seed=self.render_seed,
                                      spp_chunk=t["spp_chunk"], device=self.device)
        height = max(1, int(t["image_width"] / conf["camera"]["aspect_ratio"]))
        self.samples_per_item = t["image_width"] * height * t["samples_per_pixel"]
        self.capture_seconds = 0.0
        self.kept = []  # per sweep: (loss, g_center, g_rgb, segments, ok)

    def warm_up(self):
        """The planning sweep (the replay's per-bounce prefixes), then one
        sweep: builds the kernels and captures both chunk programs."""
        self.s["plan"](fused=True)
        self.capture_seconds += self.s["programs"].program.capture_seconds
        self.item()
        self.capture_seconds += self.s["programs"].program.capture_seconds

    def counters(self) -> dict:
        from raytracing_tpu_torch.diff import replay_kernel
        from raytracing_tpu_torch.ops import megakernel_block, table_gather

        return {"k1_launches": megakernel_block.launches,
                "k2_launches": replay_kernel.bwd_launches,
                "fold_launches": table_gather.fold_launches}

    def item(self):
        from raytracing_tpu_torch.render import graphs

        return graphs.to_host(*self.s["sweep"](fused=True))

    def keep(self, out) -> None:
        loss, gc, gr, segs, ok = out
        self.kept.append((float(loss), np.array(gc), np.array(gr), int(segs), bool(ok)))

    def work(self) -> dict:
        """The shapes that the kernels' byte counts take."""
        t = self.traffic
        B = self.s["B"]
        D = t["max_depth"]
        prefixes = [min(B, -(-int(p) // roofline.TILE) * roofline.TILE)
                    for p in self.s["ns"]["prefixes"]]
        return {"kind": KIND, "B": B, "D": D, "chunks": self.s["n_chunks"],
                "L": roofline.table_rows(**self.conf["primitives"]),
                "fold_rays_per_chunk": sum(prefixes),
                "segments_per_item": [k[3] for k in self.kept]}

    def release(self) -> None:
        self.s = None

    def reference(self, config_path, device, dtype=torch.float32):
        return reference_sweep(config_path, self.traffic, self.render_seed, device, dtype)

    def check(self, config_path, device, ref=None) -> list:
        """The compared numbers of every kept sweep against the plain
        reference's sweep (``ref``, computed here if not given)."""
        ref = ref if ref is not None else self.reference(config_path, device)
        return [compare.grad_numbers(*k, *ref) for k in self.kept]

    @staticmethod
    def control_numbers(low, ref) -> dict:
        """The numbers of a lower-precision reference ``low`` put in the
        program's place."""
        return compare.grad_numbers(low[0], low[1], low[2], low[3], True, *ref)


def reference_sweep(config_path, traffic: dict, render_seed: int, device, dtype=torch.float32):
    """(loss, g_center, g_rgb, segments) of the plain reference's sweep, on the host."""
    conf, arrays = tracer.load_config(config_path)
    sc = tracer.Scene(arrays, device, dtype)
    cam = tracer.Camera(conf["camera"], traffic["image_width"], device, dtype)
    loss, gc, gr, segs = tracer.grad_sweep(sc, cam, traffic["samples_per_pixel"],
                                           traffic["spp_chunk"], traffic["max_depth"],
                                           render_seed)
    return float(loss), gc.cpu().numpy(), gr.cpu().numpy(), segs
