"""The mesh-sharded renderer, the counterpart of
``raytracing_tpu/parallel/shard.py:37-272`` (``build_sharded_renderer``,
``render_sharded``), with the same contract.

Every rank of the mesh runs the same body (``_rank_render``, JAX's
``_device_render``) on its part of the work:

* ``dp``: its block of pixels (padding pixels start dead and are clamped
  only for ray generation);
* ``sp``: its range of samples (global sample ids from the rank's
  coordinate);
* ``tp``: every ray, against its range of the primitives
  (``scene_shard.py``: all-reduce MIN; ``ring.py``: the ring; or each
  range's own BVH).

The body traces its rays in launches of its pixels × ``spp_chunk``
samples, the single-device ``Renderer``'s sample chunk for the same
configuration (``render/renderer.launch_shape``), and sums a pixel's
samples launch by launch as the ``Renderer`` does; then the partial
radiance is summed over ``sp``, averaged over ``tp`` (already
replicated), and the dp blocks are assembled by an all-reduce SUM of
zero-filled full-size buffers (adding zeros is exact). RNG is
counter-based on global (pixel, sample, bounce) ids (``core/rng.py``), so
a dp render equals the single-device render bit for bit and an sp or tp
render to float32 association. ``hit_method="mega"`` runs K1 (or K5) on
every rank's launches, dp and sp meshes only; each rank's launch is a
multiple of the kernels' 1024-ray block.

Gradients: the render's scene and camera tensors enter through
``_SceneIn``, whose backward all-reduces their cotangents over the whole
mesh (JAX's ``shard_map`` boundary), and the returned image's cotangent
is each rank's share (``mesh.replicated_output``); every rank then holds
the whole gradient. With ``grad_psum_axes`` each bounce's scene cotangent
is all-reduced over those axes asynchronously during the backward sweep
(``render/integrator.GradPsum``), and the boundary waits for them.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.intersect import closest_hit_brute
from ..ops.megakernel import BLOCK, build_mega_scene, trace_megakernel
from ..ops.traverse import closest_hit_bvh
from ..render import camera as cam_mod
from ..render.camera import CameraConfig, CameraParams
from ..render.integrator import GradPsum, trace
from ..render.renderer import launch_shape
from ..scene.types import Scene, float_leaves, with_leaves
from .mesh import Mesh, pmean, psum, replicated_output
from .ring import closest_hit_ring
from .scene_shard import (closest_hit_scene_sharded, closest_hit_scene_sharded_bvh,
                          shard_of, shard_scene_primitives)

HIT_METHODS = ("brute", "bvh", "ring", "mega")


class _SceneIn(torch.autograd.Function):
    """The identity on the scene and camera tensors a sharded render reads,
    whose backward all-reduces their cotangents over every axis of the
    mesh, and adds the per-bounce sums of ``grad_psum`` (reduced over its
    axes during the sweep) after reducing them over the other axes.
    Every rank issues the same collectives (zeros where it has no
    cotangent)."""

    @staticmethod
    def forward(ctx, mesh, grad_psum, rest_group, *xs):
        ctx.mesh, ctx.grad_psum, ctx.rest_group = mesh, grad_psum, rest_group
        ctx.like = xs
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        like = ctx.like
        gs = [torch.zeros_like(x) if g is None else g for x, g in zip(like, gs)]
        flat = torch.cat([g.reshape(-1) for g in gs])
        group = ctx.mesh.group(ctx.mesh.axis_names)
        if group is not None:
            dist.all_reduce(flat, group=group)
        if ctx.grad_psum is not None:
            rest = torch.cat([g.reshape(-1) for g in ctx.grad_psum.collect(like)])
            if ctx.rest_group is not None:
                dist.all_reduce(rest, group=ctx.rest_group)
            flat = flat + rest
        out, off = [], 0
        for x in like:
            out.append(flat[off:off + x.numel()].view_as(x))
            off += x.numel()
        return (None, None, None, *out)


def build_sharded_renderer(scene: Scene, cfg: CameraConfig, mesh: Mesh, *,
                           hit_method: str = "brute", grad_psum_axes: tuple = ()):
    """A mesh-sharded render function for this rank.

    ``scene`` lies on the rank's device (``mesh.device``). ``hit_method``:
    ``"brute"`` (the wavefront integrator), ``"bvh"`` (with the scene's
    BVH, or each tp range's own), ``"ring"`` (tp only) or ``"mega"`` (K1
    or K5 on each rank's launches; dp/sp meshes only, forward only).
    ``grad_psum_axes``: all-reduce each bounce's scene cotangent over
    these axes during the backward sweep (not ``tp``, whose ranks hold
    different ranges).

    Returns ``(fn, scene_prepared, n_pix_pad)`` where
    ``fn(scene_prepared, params, seed, sample_range=None) -> (radiance
    (n_pix_pad, 3) sample sum, segments int)``, the same on every rank
    (rank r's pixels are its dp block; the JAX ``fn`` takes the pixel ids
    sharded over dp instead). ``sample_range`` = ``[start, stop)`` of
    global samples (default: all): renders of disjoint windows sum to the
    whole render (the checkpoint unit of ``multihost.py``)."""
    names = mesh.axis_names
    if "dp" not in names:
        raise ValueError("mesh must have a 'dp' axis")
    if hit_method not in HIT_METHODS:
        raise ValueError(f"hit_method must be one of {HIT_METHODS}, got {hit_method!r}")
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside this mesh of {mesh.n} ranks")
    tp = "tp" if "tp" in names else None
    sp = "sp" if "sp" in names else None
    ndp, ntp, nsp = mesh.size("dp"), mesh.size(tp) if tp else 1, mesh.size(sp) if sp else 1
    grad_psum_axes = tuple(grad_psum_axes)
    if tp in grad_psum_axes and ntp > 1:
        raise ValueError("grad_psum_axes cannot hold 'tp': its ranks hold different ranges "
                         "of the scene")
    mega = None
    if hit_method == "mega":
        if tp is not None:
            raise ValueError("hit_method='mega' needs the whole scene on every rank (no tp "
                             "axis); use a tp mode for scenes too large to replicate")
        mega = build_mega_scene(scene)
    if hit_method == "ring" and tp is None:
        raise ValueError("hit_method='ring' shards the scene over a 'tp' axis")
    if tp is not None:
        scene = shard_scene_primitives(scene, ntp, use_bvh=hit_method == "bvh")
        fn = {"ring": closest_hit_ring, "bvh": closest_hit_scene_sharded_bvh}.get(
            hit_method, closest_hit_scene_sharded)
        hit_fn = _local_range(fn, mesh, tp)
    elif hit_method == "bvh":
        if scene.bvh is None:
            raise ValueError("hit_method='bvh' needs a scene compiled with use_bvh=True")
        hit_fn = closest_hit_bvh
    else:
        hit_fn = closest_hit_brute

    spp = cfg.samples_per_pixel
    spp_local = -(-spp // nsp)
    k = min(launch_shape(cfg)[1], spp_local)
    unit = ndp * (BLOCK // math.gcd(k, BLOCK) if mega is not None else 1)
    n_pix_pad = -(-cfg.n_pixels // unit) * unit
    p_local = n_pix_pad // ndp
    phases = [2, 3, cfg.max_depth - 5] if cfg.max_depth > 6 else None
    body = partial(_rank_render, cfg=cfg, mesh=mesh, p_local=p_local, spp_local=spp_local,
                   k=k, sp=sp, hit_fn=hit_fn, mega=mega, phases=phases)
    rest = tuple(a for a in names if a not in grad_psum_axes)

    def call(scene_a: Scene, params: CameraParams, seed: int, sample_range=None):
        lo, hi = (0, spp) if sample_range is None else (int(x) for x in sample_range)
        grad_psum = None
        if torch.is_grad_enabled():
            ls = {p: v for p, v in float_leaves(scene_a) if v.requires_grad}
            lc = {p: v for p, v in float_leaves(params) if v.requires_grad}
            if ls or lc:
                if grad_psum_axes:
                    grad_psum = GradPsum(mesh.group(grad_psum_axes))
                outs = _SceneIn.apply(mesh, grad_psum, mesh.group(rest) if rest else None,
                                      *ls.values(), *lc.values())
                scene_a = with_leaves(scene_a, dict(zip(ls, outs[:len(ls)])))
                params = with_leaves(params, dict(zip(lc, outs[len(ls):])))
        part, segments = body(scene_a, params, seed, lo, hi, grad_psum=grad_psum)
        if sp is not None:
            part, segments = psum(part, mesh, sp), psum(segments, mesh, sp)
        if tp is not None:
            # every tp rank traced the same rays: the replicated mean and count
            part = pmean(part, mesh, tp)
            segments = psum(segments, mesh, tp) // ntp
        d0 = mesh.index("dp") * p_local
        full = F.pad(part, (0, 0, d0, n_pix_pad - d0 - p_local))
        full, segments = psum(full, mesh, "dp"), psum(segments, mesh, "dp")
        return replicated_output(full, mesh), int(segments)

    return call, scene, n_pix_pad


def _local_range(fn, mesh: Mesh, axis: str):
    """A closest hit over this rank's tp range of the prepared scene."""
    k, n = mesh.index(axis), mesh.size(axis)

    def hit(scene, o, d, time, t_min):
        return fn(shard_of(scene, k, n), o, d, time, t_min, mesh=mesh, axis=axis)

    return hit


def _rank_render(scene: Scene, params: CameraParams, seed: int, lo: int, hi: int, *,
                 cfg: CameraConfig, mesh: Mesh, p_local: int, spp_local: int, k: int,
                 sp: Optional[str], hit_fn, mega, phases, grad_psum):
    """This rank's part (``raytracing_tpu/parallel/shard.py:37-142``): its
    dp pixel block × its samples of the window ``[lo, hi)``, in launches
    of ``k`` samples. Returns (radiance summed over those samples
    (p_local, 3), segments as a 0-d int64 tensor)."""
    dev = mesh.device
    s0 = lo + (mesh.index(sp) * spp_local if sp is not None else 0)
    s_end = min(s0 + spp_local, hi)
    pixel_ids = mesh.index("dp") * p_local + torch.arange(p_local, device=dev)
    pix_valid = pixel_ids < cfg.n_pixels
    pix = torch.clamp(pixel_ids, max=cfg.n_pixels - 1).repeat(k)
    alive_pix = pix_valid.repeat(k)
    derived = cam_mod.derive(cfg, params)
    part = torch.zeros((p_local, 3), dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    for c0 in range(s0, s_end, k):
        samp = c0 + torch.arange(k, device=dev).repeat_interleave(p_local)
        active0 = alive_pix & (samp < s_end)
        o, d, t = cam_mod.generate_rays(cfg, derived, pix, samp, seed,
                                        motion_blur=scene.flags.has_moving)
        if mega is not None:
            rad, seg = trace_megakernel(mega, o, d, t, pix, samp, cfg.background, cfg.max_depth,
                                        seed, phase_depths=phases, active0=active0)[:2]
        else:
            rad, seg = trace(scene, o, d, t, pix, samp, cfg.background, cfg.max_depth, seed,
                             hit_fn=hit_fn, mode="scan", remat=False, active0=active0,
                             grad_psum=grad_psum)
        rad = torch.where(active0[:, None], rad, 0.0)
        part = part + rad.reshape(k, p_local, 3).sum(dim=0)
        segments = segments + seg
    return part, segments


def render_sharded(scene: Scene, cfg: CameraConfig, mesh: Mesh,
                   params: Optional[CameraParams] = None, seed: int = 0, *,
                   hit_method: str = "brute"):
    """One sharded render → ((H, W, 3) mean radiance as a numpy array,
    segments), the same on every rank of the mesh."""
    fn, scene_prep, _ = build_sharded_renderer(scene, cfg, mesh, hit_method=hit_method)
    if params is None:
        params = CameraParams.from_config(cfg, mesh.device)
    with torch.no_grad():
        part, segments = fn(scene_prep, params, seed)
        # divided on the device, as the Renderer divides (on the card PyTorch
        # multiplies by the reciprocal of a scalar divisor)
        mean = (part[:cfg.n_pixels] / cfg.samples_per_pixel).cpu().numpy()
    return mean.reshape(cfg.image_height, cfg.image_width, 3), segments
