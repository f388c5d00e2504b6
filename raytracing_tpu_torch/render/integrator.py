"""The wavefront path-tracing integrator, the counterpart of
``raytracing_tpu.render.integrator``: the recursive ``ray_color`` unrolled
into per-bounce updates of a batch of rays,

    radiance   += throughput · emitted        (on a hit)
    radiance   += throughput · background     (on a miss, then the ray dies)
    throughput *= attenuation                 (on a scatter)
    the ray dies on an absorb,

in plain PyTorch with autograd. ``mode="scan"`` runs every bounce (each one
checkpointed when ``remat``, so the backward recomputes a bounce instead
of storing its temporaries); ``mode="while"`` stops once every ray is dead.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng as rng_mod
from ..ops.intersect import T_MIN, HitBatch, closest_hit_brute
from ..ops.scatter import scatter_and_emit
from ..scene.types import Scene

HitFn = Callable[..., HitBatch]  # (scene, o, d, time, t_min) -> HitBatch


def _bounce_once(scene: Scene, background: torch.Tensor, seed, hit_fn: HitFn, state,
                 bounce: int):
    """One wavefront bounce. ``state`` = (o, d, time, pixel, sample,
    radiance, throughput, active, segments)."""
    o, d, time, pixel, sample, radiance, throughput, active, segments = state
    hit = hit_fn(scene, o, d, time, T_MIN)

    miss = active & ~hit.valid
    radiance = radiance + torch.where(miss[:, None], throughput * background[None, :], 0.0)

    ctr = bounce * rng_mod.N_STREAMS + rng_mod.STREAM_SCATTER
    sc = scatter_and_emit(scene, d, hit, rng_mod.uniform4(pixel, sample, ctr, seed))

    hit_mask = active & hit.valid
    radiance = radiance + torch.where(hit_mask[:, None], throughput * sc.emitted, 0.0)
    live = hit_mask & sc.did_scatter
    throughput = torch.where(live[:, None], throughput * sc.attenuation, throughput)
    o = torch.where(live[:, None], hit.p, o)
    d = torch.where(live[:, None], sc.direction, d)
    segments = segments + active.sum()
    return (o, d, time, pixel, sample, radiance, throughput, live, segments)


def initial_state(o, d, time, pixel_ids, sample_ids, active0=None):
    """The bounce state of fresh camera rays: zero radiance, unit
    throughput, alive unless ``active0`` says otherwise."""
    B = o.shape[0]
    return (o, d, time, pixel_ids, sample_ids,
            torch.zeros((B, 3), dtype=torch.float32, device=o.device),
            torch.ones((B, 3), dtype=torch.float32, device=o.device),
            torch.ones(B, dtype=torch.bool, device=o.device) if active0 is None
            else active0.to(torch.bool),
            torch.zeros((), dtype=torch.int64, device=o.device))


def run_bounce(body, state, remat: bool):
    """``body(state)``, checkpointed (recomputed in the backward) when
    ``remat`` and autograd is recording."""
    if remat and torch.is_grad_enabled():
        return checkpoint(body, state, use_reentrant=False)
    return body(state)


def trace(scene: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
          pixel_ids: torch.Tensor, sample_ids: torch.Tensor, background, max_depth: int,
          seed, hit_fn: HitFn = closest_hit_brute, mode: str = "scan", remat: bool = True,
          active0=None):
    """Trace a batch of rays (o, d (B, 3), time (B,), pixel and sample ids
    (B,) i32 as the RNG identity) to completion.

    Returns ``(radiance (B, 3), segments)``, ``segments`` a Python int: the
    ray-scene queries actually traced. Rays still alive after
    ``max_depth`` bounces add nothing more."""
    if mode not in ("scan", "while"):
        raise ValueError(f"mode must be 'scan' or 'while', got {mode!r}")
    background = torch.as_tensor(background, dtype=torch.float32, device=o.device)
    state = initial_state(o, d, time, pixel_ids, sample_ids, active0)
    for bounce in range(max_depth):
        if mode == "while" and not bool(state[7].any()):
            break
        state = run_bounce(
            lambda st, b=bounce: _bounce_once(scene, background, seed, hit_fn, st, b),
            state, remat and mode == "scan")
    return state[5], int(state[8])
