"""Inverse-rendering loops over scene parameters, the counterpart of
``raytracing_tpu.diff.optimize``: fit sphere geometry or albedos to a
target image by gradient descent (``torch.optim.Adam`` in place of
``optax.adam``, with the same learning rate and epsilon).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..render.camera import CameraConfig
from ..scene.types import Scene
from .gradients import mse_loss

ADAM_EPS = 1e-8  # optax.adam's default


def fit_scene(scene: Scene, target: torch.Tensor, cfg: CameraConfig,
              param_filter: Callable[[Scene], Any], apply_update: Callable[[Scene, Any], Scene],
              steps: int = 100, lr: float = 1e-2, seed: int = 0,
              reseed_every_step: bool = True,
              optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
              **render_kwargs) -> Tuple[Scene, torch.Tensor]:
    """Generic fitting loop. ``param_filter(scene)`` picks the optimised
    tensor or tuple of tensors; ``apply_update(scene, params)`` writes them
    back. Returns the fitted scene and the loss history (steps,).

    ``reseed_every_step`` renders step k with seed ``seed + k``, so the
    Monte Carlo noise decorrelates across steps (the loss floor is then
    the noise's variance); without it every step uses ``seed``, and a fit
    against a target rendered with that seed goes to ~0. ``optimizer``
    makes the optimizer from the parameter list (default Adam)."""
    p0 = param_filter(scene)
    single = torch.is_tensor(p0)
    params = [t.detach().clone().requires_grad_(True) for t in ((p0,) if single else p0)]
    opt = (optimizer(params) if optimizer is not None
           else torch.optim.Adam(params, lr=lr, eps=ADAM_EPS))

    def current():
        return apply_update(scene, params[0] if single else tuple(params))

    losses = []
    for k in range(steps):
        opt.zero_grad()
        loss = mse_loss(current(), target, cfg,
                        seed=seed + k if reseed_every_step else seed, **render_kwargs)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        fitted = apply_update(scene, tuple(p.detach() for p in params) if not single
                              else params[0].detach())
    return fitted, torch.tensor(losses)


def fit_sphere_params(scene: Scene, target, cfg, steps=100, lr=1e-2, **kw):
    """Optimise sphere centers and radii."""
    def get(s):
        return (s.spheres.center, s.spheres.radius)

    def put(s, p):
        return dataclasses.replace(
            s, spheres=dataclasses.replace(s.spheres, center=p[0], radius=p[1]))

    return fit_scene(scene, target, cfg, get, put, steps=steps, lr=lr, **kw)


def fit_albedo(scene: Scene, target, cfg, steps=100, lr=5e-2, **kw):
    """Optimise the texture rgb table (albedos and emission)."""
    def get(s):
        return s.textures.rgb

    def put(s, p):
        return dataclasses.replace(s, textures=dataclasses.replace(s.textures, rgb=p))

    return fit_scene(scene, target, cfg, get, put, steps=steps, lr=lr, **kw)
