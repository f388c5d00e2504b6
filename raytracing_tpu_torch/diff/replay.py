"""Decision-replay differentiable rendering, the counterpart of
``raytracing_tpu.diff.replay``.

The closest-hit search only decides which primitive each bounce hits, and
under the pathwise-gradient contract (``diff/gradients.py``) that
decision is a constant of the differentiation. So rendering splits in
two passes:

1. a decision pass, not differentiated, that records the winning global
   primitive id per (bounce, ray), -1 on a miss: :func:`record_decisions`
   (the wavefront integrator) or K1 with ``want_ids``;
2. a replay, differentiated, that re-traces the same paths but
   intersects only the recorded winner (:func:`hit_from_id`) and shares
   the integrator's bounce body, so its radiance and segments equal the
   forward trace's and its gradient equals the full forward's wherever
   the decisions are locally constant.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import vecmath as vm
from ..ops.intersect import (
    BIG,
    PARALLEL_EPS,
    T_MIN,
    HitBatch,
    closest_hit_brute,
    hit_attributes,
    quad_plane_basis,
    safe_sqrt_rn,
)
from ..ops.megakernel import BLOCK, build_mega_scene, trace_megakernel
from ..render import camera as cam_mod
from ..render.camera import CameraConfig, CameraParams
from ..render.integrator import _bounce_once, initial_state, run_bounce
from ..render.renderer import chunk_rays
from ..scene import flatten as fl
from ..scene.types import Scene, refuse_media


def record_decisions(scene: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                     pixel_ids: torch.Tensor, sample_ids: torch.Tensor, background,
                     max_depth: int, seed, hit_fn: Callable = closest_hit_brute, active0=None,
                     return_active: bool = False):
    """The integrator's decision pass: the winning global primitive id per
    (bounce, ray), ``(max_depth, B) i32``, -1 on a miss (a ray that is
    already dead records whatever its frozen state hits; the replay never
    reads it). ``return_active`` also returns the ``(max_depth, B)`` bool
    mask of rays alive entering each bounce. Runs without autograd."""
    refuse_media(scene, "the decision pass of the replay")
    background = torch.as_tensor(background, dtype=torch.float32, device=o.device)
    ids, act = [], []
    with torch.no_grad():
        st = initial_state(o, d, time, pixel_ids, sample_ids, active0)
        for bounce in range(max_depth):
            hit = hit_fn(scene, st[0], st[1], st[2], T_MIN)
            ids.append(hit.prim_id)
            act.append(st[7])
            st = _bounce_once(scene, background, seed, lambda *_: hit, st, bounce)
    ids = torch.stack(ids) if ids else torch.zeros((0, o.shape[0]), dtype=torch.int32,
                                                   device=o.device)
    if return_active:
        return ids, torch.stack(act) if act else torch.zeros_like(ids, dtype=torch.bool)
    return ids


def winner_t(scene: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
             prim_id: torch.Tensor, t_min: float = T_MIN) -> torch.Tensor:
    """The recorded winner's t (B,), +inf where ``prim_id`` is -1, with
    autograd: the single-primitive forms of ``sphere_ts`` and ``quad_ts``.
    It equals the sweep's candidate t for the winner: the nearest root in
    (t_min, closest so far) of the winning sphere is its nearest root in
    (t_min, ∞)."""
    n_sph = scene.n_spheres
    valid = prim_id >= 0
    pid = torch.where(valid, prim_id, 0).long()
    is_quad = pid >= n_sph
    sid = torch.clamp(pid, 0, n_sph - 1)
    qid = torch.clamp(pid - n_sph, 0, scene.n_quads - 1)

    sph = scene.spheres
    c = sph.center[sid]
    if scene.flags.has_moving:
        c = c + time[:, None] * sph.velocity[sid]
    oc = o - c
    a = vm.length_squared(d)
    half_b = vm.dot(oc, d)
    r = sph.radius[sid]
    cq = vm.length_squared(oc) - r * r
    disc = half_b * half_b - a * cq
    sqrtd = safe_sqrt_rn(disc)
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    t_s = torch.where(root0 > t_min, root0, root1)

    normal_all, dconst_all, _, _ = quad_plane_basis(scene.quads)
    qn = normal_all[qid]
    denom = vm.dot(qn, d)
    safe_denom = torch.where(torch.abs(denom) < PARALLEL_EPS, 1.0, denom)
    t_q = (dconst_all[qid] - vm.dot(qn, o)) / safe_denom
    return torch.where(valid, torch.where(is_quad, t_q, t_s), BIG)


def hit_from_id(scene: Scene, prim_id: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                time: torch.Tensor, t_min: float = T_MIN) -> HitBatch:
    """The full differentiable hit record of a recorded winner id."""
    t = winner_t(scene, o, d, time, prim_id, t_min)
    return hit_attributes(scene, o, d, time, t, torch.where(prim_id >= 0, prim_id, 0))


def replay_trace(scene: Scene, ids: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                 time: torch.Tensor, pixel_ids: torch.Tensor, sample_ids: torch.Tensor,
                 background, max_depth: int, seed, remat: bool = True, active0=None):
    """Differentiable replay of the recorded ``ids (max_depth, B)``:
    ``(radiance (B, 3), segments)``, ``segments`` a Python int. The
    integrator's bounce body with the closest-hit search replaced by the
    winner's recompute; liveness replays from the same RNG streams, so the
    segments are the traced ones."""
    refuse_media(scene, "the gradient replay")
    background = torch.as_tensor(background, dtype=torch.float32, device=o.device)
    st = initial_state(o, d, time, pixel_ids, sample_ids, active0)

    def body(st, bounce):
        ids_b = ids[bounce]
        return _bounce_once(scene, background, seed,
                            lambda sc, oo, dd, tt, tmin: hit_from_id(sc, ids_b, oo, dd, tt, tmin),
                            st, bounce)

    for bounce in range(max_depth):
        st = run_bounce(lambda s, b=bounce: body(s, b), st, remat)
    return st[5], int(st[8])


def _params(cfg, params, scene):
    return params if params is not None else CameraParams.from_config(
        cfg, scene.spheres.center.device)


def render_replay(scene: Scene, cfg: CameraConfig, params: Optional[CameraParams] = None,
                  seed: int = 0, ids: Optional[torch.Tensor] = None,
                  hit_fn: Callable = closest_hit_brute, remat: bool = True,
                  sample_start: int = 0, spp: Optional[int] = None,
                  return_segments: bool = False):
    """The replay counterpart of ``diff/gradients.py`` ``render_once``:
    the same (H, W, 3) image, but autograd through it never reaches the
    closest-hit search. ``ids`` skips the decision pass (from K1's
    ``want_ids``, say); else :func:`record_decisions` records them."""
    params = _params(cfg, params, scene)
    n_pix = cfg.n_pixels
    spp = cfg.samples_per_pixel if spp is None else spp
    o, d, t, pix, smp, _, _ = chunk_rays(
        cfg, cam_mod.derive(cfg, params), 0, sample_start, seed, n_block=n_pix, spp_chunk=spp,
        has_moving=scene.flags.has_moving, device=scene.spheres.center.device)
    if ids is None:
        ids = record_decisions(scene, o.detach(), d.detach(), t.detach(), pix, smp,
                               cfg.background, cfg.max_depth, seed, hit_fn=hit_fn)
    radiance, segments = replay_trace(scene, ids, o, d, t, pix, smp, cfg.background,
                                      cfg.max_depth, seed, remat=remat)
    img = radiance.reshape(spp, n_pix, 3).mean(0).reshape(cfg.image_height, cfg.image_width, 3)
    return (img, segments) if return_segments else img


def render_replay_fast(scene: Scene, cfg: CameraConfig, params: Optional[CameraParams] = None,
                       seed: int = 0, remat: bool = True, sample_start: int = 0,
                       spp: Optional[int] = None, return_segments: bool = False,
                       phase_depths=None, ids: Optional[torch.Tensor] = None,
                       return_ids: bool = False):
    """:func:`render_replay` with the megakernel as the decision pass:
    the pixel batch is padded to a multiple of 1024 rays (padding rays
    start dead), ``trace_megakernel(want_ids=True)`` records the winner
    ids without autograd (K1 on the card, its plain version for CPU
    tensors), and only the replay is differentiated. A scene the
    megakernel's tables cannot express (a checker of non-solid textures,
    bilinear image filtering) takes :func:`render_replay`'s integrator
    decision pass instead, as in the JAX package. ``return_ids`` also
    returns the ids, which ``ids=`` takes back to skip the decision pass."""
    params = _params(cfg, params, scene)
    if ids is None and not fl.unified_table(scene)[3]:
        if return_ids:
            raise ValueError("scene unsupported by the megakernel: no ids to return")
        return render_replay(scene, cfg, params, seed, remat=remat, sample_start=sample_start,
                             spp=spp, return_segments=return_segments)
    n_pix = cfg.n_pixels
    spp = cfg.samples_per_pixel if spp is None else spp
    dev = scene.spheres.center.device
    npix_pad = -(-n_pix // BLOCK) * BLOCK
    o, d, t, pix, smp, _, _ = chunk_rays(
        cfg, cam_mod.derive(cfg, params), 0, sample_start, seed, n_block=npix_pad,
        spp_chunk=spp, has_moving=scene.flags.has_moving, device=dev)
    active0 = (torch.arange(npix_pad, device=dev) < n_pix).repeat(spp)
    if ids is None:
        with torch.no_grad():
            _, _, ids = trace_megakernel(build_mega_scene(scene), o.detach(), d.detach(),
                                         t.detach(), pix, smp, cfg.background, cfg.max_depth,
                                         seed, phase_depths=phase_depths, active0=active0,
                                         want_ids=True)
    radiance, segments = replay_trace(scene, ids, o, d, t, pix, smp, cfg.background,
                                      cfg.max_depth, seed, remat=remat, active0=active0)
    img = (radiance * active0[:, None]).reshape(spp, npix_pad, 3).mean(0)[:n_pix]
    out = (img.reshape(cfg.image_height, cfg.image_width, 3),)
    if return_segments:
        out += (segments,)
    if return_ids:
        out += (ids,)
    return out[0] if len(out) == 1 else out

