"""Entry point of the port, the counterpart of ``__graft_entry__.entry``:

``entry()`` → ``(forward, (scene, params))``: one differentiable forward
render (``diff.gradients.render_once``, the wavefront integrator) of the
flagship scene, bouncing_spheres at 96 px wide, 2 spp, depth 6, on the
card unless ``device`` names another. ``forward(scene, params)`` returns
the (H, W, 3) mean radiance with autograd.

There is no ``dryrun_multichip`` yet: the port has no multi-device
renderer.
"""
from __future__ import annotations

from .core.device import DEFAULT_DEVICE, resolve


def entry(device=DEFAULT_DEVICE, image_width: int = 96):
    from .diff.gradients import render_once
    from .models.scenes import build
    from .render.camera import CameraParams

    dev = resolve(device)
    scene, cfg = build("bouncing_spheres", device=dev, image_width=image_width,
                       samples_per_pixel=2, max_depth=6)
    params = CameraParams.from_config(cfg, dev)

    def forward(scene_arg, params_arg):
        return render_once(scene_arg, cfg, params_arg, seed=0)

    return forward, (scene, params)
