"""Pipeline-parallel (PP) rendering, the counterpart of
``raytracing_tpu/parallel/pp.py:49-165``: the bounces of a path staged
across the ``pp`` ranks, microbatches of rays streaming through them.

* Stage p applies the bounce window ``[b0_p, b0_p + n_p)`` of the depth
  (the windows cover ``max_depth``; earlier stages take the remainder,
  as they see the most live rays).
* The (pixel × sample) stream is cut into M microbatches, each a range of
  samples of every pixel. At step t stage p holds microbatch t − p:
  stage 0 makes it from camera rays, every stage advances it through its
  window with the single-device integrator's ``_bounce_once`` at the
  global bounce index (so each path draws the same random numbers), and
  the state moves one stage down (``batch_isend_irecv``; JAX shifts with
  ``lax.ppermute``). A stage computes only the steps at which it holds a
  microbatch, and sends only those.
* The last stage banks each finished microbatch's radiance and segments;
  an all-reduce SUM over the axis replicates them.

Each path's radiance is bit-identical to the single-device integrator's:
the pipeline reorders nothing within a path. Forward only (the sends are
not recorded by autograd). Send/recv needs gloo on CPU tensors or NCCL
with a card a rank (``mesh.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.intersect import closest_hit_brute
from ..render import camera as cam_mod
from ..render.camera import CameraConfig, CameraParams
from ..render.integrator import _bounce_once, initial_state
from ..scene.types import Scene
from .mesh import Mesh, psum


def _stage_windows(max_depth: int, n_stages: int):
    """``(starts, sizes)`` of the stages' contiguous bounce windows."""
    base, rem = divmod(max_depth, n_stages)
    sizes = [base + (1 if p < rem else 0) for p in range(n_stages)]
    return [sum(sizes[:p]) for p in range(n_stages)], sizes


def build_pp_renderer(scene: Scene, cfg: CameraConfig, mesh: Mesh, axis: str = "pp",
                      hit_fn=closest_hit_brute, n_micro: Optional[int] = None):
    """Returns ``(render_fn, n_rays_pad, n_micro)``, where
    ``render_fn(scene, params, seed) -> (radiance (n_rays_pad, 3),
    segments int)`` renders the whole sample-major stream (ray ``i`` is
    pixel ``i % B`` of sample ``i // B``, B the pixel count padded to 1024;
    padding pixels are dead) through the pipeline, the same on every rank
    of the axis. ``n_micro`` defaults to 2·stages, at most spp, lowered
    until it divides spp."""
    n_stages = mesh.size(axis)
    spp = cfg.samples_per_pixel
    if n_micro is None:
        n_micro = max(1, min(2 * n_stages, spp))
    if n_micro > spp:
        raise ValueError("n_micro must not exceed samples_per_pixel")
    while spp % n_micro:
        n_micro -= 1
    spb = spp // n_micro
    B = -(-cfg.n_pixels // 1024) * 1024
    n_rays_pad = B * spp
    starts, sizes = _stage_windows(cfg.max_depth, n_stages)
    dev = mesh.device
    n_pix = cfg.n_pixels

    def fresh(derived, m: int, seed: int):
        """Microbatch m's camera rays as a bounce state."""
        lane = torch.arange(B * spb, device=dev)
        pix = torch.clamp(lane % B, max=n_pix - 1)
        smp = m * spb + torch.div(lane, B, rounding_mode="floor")
        o, d, t = cam_mod.generate_rays(cfg, derived, pix, smp, seed,
                                        motion_blur=scene.flags.has_moving)
        return initial_state(o, d, t, pix, smp, (lane % B) < n_pix)

    def render_fn(scene_a: Scene, params: CameraParams, seed: int):
        p = mesh.index(axis)
        nxt, prv = mesh.peer(axis, 1), mesh.peer(axis, -1)
        group = mesh.group(axis)
        bg = torch.as_tensor(cfg.background, dtype=torch.float32, device=dev)
        with torch.no_grad():
            derived = cam_mod.derive(cfg, params)
            template = fresh(derived, 0, seed)
            out = torch.zeros((n_micro, B * spb, 3), dtype=torch.float32, device=dev)
            segs = torch.zeros((), dtype=torch.int64, device=dev)
            st = None
            for t in range(n_micro + n_stages - 1):
                m = t - p  # the microbatch this stage holds at step t
                if p == 0 and m < n_micro:
                    st = fresh(derived, m, seed)
                if 0 <= m < n_micro:
                    for k in range(sizes[p]):
                        st = _bounce_once(scene_a, bg, seed, hit_fn, st, starts[p] + k)
                    if p == n_stages - 1:
                        out[m] = st[5]
                        segs += st[8]
                # send the held microbatch down, receive the next one
                ops, recv = [], None
                if p < n_stages - 1 and 0 <= m < n_micro:
                    ops += [dist.P2POp(dist.isend, x.reshape(-1).contiguous(), nxt, group)
                            for x in st]
                if p > 0 and 0 <= m + 1 < n_micro:
                    recv = [torch.empty_like(x).reshape(-1) for x in template]
                    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recv]
                if ops:
                    for work in dist.batch_isend_irecv(ops):
                        work.wait()
                if recv is not None:
                    st = tuple(r.view_as(x) for r, x in zip(recv, template))
            out = psum(out, mesh, axis)
            segs = psum(segs, mesh, axis)
        return out.reshape(n_micro * B * spb, 3), int(segs)

    return render_fn, n_rays_pad, n_micro
