"""Differentiable rendering: image losses and their gradients with
respect to scene and camera parameters, the counterpart of
``raytracing_tpu.diff.gradients``.

The gradients are *pathwise interior* gradients, the contract of path
tracers without edge sampling:

* discrete decisions (hit or miss, the winning primitive, the material
  branch, the Fresnel coin) are constants of the differentiation, so
  visibility and boundary terms are not produced;
* shading parameters (albedo, emission, any texture value) always get
  their exact gradient;
* geometry, camera, fuzz and ior get gradients through every continuous
  dependence: hit point → texture value (marble noise, bilinear images),
  hit point → next bounce's ray. Under flat shading (solid colours, a
  constant background) the radiance is piecewise constant in geometry,
  and those gradients are exactly zero.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.intersect import closest_hit_brute
from ..render import camera as cam_mod
from ..render.camera import CameraConfig, CameraParams
from ..render.integrator import trace
from ..render.renderer import chunk_rays
from ..scene.types import Scene, float_leaves, with_leaves


def render_once(scene: Scene, cfg: CameraConfig, params: Optional[CameraParams] = None,
                seed: int = 0, hit_fn: Callable = closest_hit_brute, remat: bool = True,
                sample_start: int = 0, spp: Optional[int] = None,
                return_segments: bool = False):
    """One differentiable render through the wavefront integrator →
    (H, W, 3) mean radiance on the scene's device.

    ``sample_start``/``spp`` select a range of samples (the same RNG
    streams as the whole render, so a large render can be accumulated in
    ranges); ``return_segments`` also returns the traced segments (a
    Python int). The brute-force sweep holds ``(B, N)`` temporaries per
    bounce for B = pixels × spp rays over N primitives."""
    if params is None:
        params = CameraParams.from_config(cfg, scene.spheres.center.device)
    n_pix = cfg.n_pixels
    spp = cfg.samples_per_pixel if spp is None else spp
    o, d, t, pixel_ids, sample_ids, _, _ = chunk_rays(
        cfg, cam_mod.derive(cfg, params), 0, sample_start, seed, n_block=n_pix,
        spp_chunk=spp, has_moving=scene.flags.has_moving, device=scene.spheres.center.device)
    radiance, segments = trace(scene, o, d, t, pixel_ids, sample_ids, cfg.background,
                               cfg.max_depth, seed, hit_fn=hit_fn, mode="scan", remat=remat)
    img = radiance.reshape(spp, n_pix, 3).mean(0).reshape(cfg.image_height, cfg.image_width, 3)
    return (img, int(segments)) if return_segments else img


def mse_loss(scene: Scene, target: torch.Tensor, cfg: CameraConfig,
             params: Optional[CameraParams] = None, seed: int = 0, **kwargs) -> torch.Tensor:
    """Mean squared pixel error of :func:`render_once` against ``target``."""
    return torch.mean((render_once(scene, cfg, params, seed, **kwargs) - target) ** 2)


def _grad_tree(obj, loss_of):
    """The cotangent of ``loss_of(obj)`` as an ``obj``-shaped tree: every
    floating-point tensor replaced by its gradient (integer tensors are
    kept as they are)."""
    leaves = {p: v.detach().requires_grad_(True) for p, v in float_leaves(obj)}
    grads = torch.autograd.grad(loss_of(with_leaves(obj, leaves)), list(leaves.values()),
                                allow_unused=True)
    return with_leaves(obj, {p: torch.zeros_like(v) if g is None else g
                             for (p, v), g in zip(leaves.items(), grads)})


def scene_grad(scene: Scene, target: torch.Tensor, cfg: CameraConfig, seed: int = 0,
               **kwargs) -> Scene:
    """∂MSE/∂scene: a :class:`Scene` whose float tensors are the gradients."""
    return _grad_tree(scene, lambda s: mse_loss(s, target, cfg, seed=seed, **kwargs))


def camera_grad(scene: Scene, target: torch.Tensor, cfg: CameraConfig, params: CameraParams,
                seed: int = 0, **kwargs) -> CameraParams:
    """∂MSE/∂camera: a :class:`CameraParams` of gradients."""
    return _grad_tree(params, lambda p: mse_loss(scene, target, cfg, params=p, seed=seed,
                                                 **kwargs))
