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

``trace(grad_psum=)`` is the per-bounce gradient all-reduce of a sharded
render (``raytracing_tpu/render/integrator.py:66-115``
``make_overlapped_bounce`` and ``trace``'s ``grad_psum_axes``,
``:116-181``): each bounce's backward starts an asynchronous all-reduce
of its scene-parameter cotangent, and the render's scene input
(``parallel/shard.py``) waits for them once the whole backward sweep has
run, so the communication overlaps the earlier bounces' backward.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..core import rng as rng_mod
from ..ops.intersect import T_MIN, HitBatch, closest_hit_brute
from ..ops.scatter import scatter_and_emit
from ..scene.types import Scene, float_leaves, refuse_media, with_leaves

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


class GradPsum:
    """The per-bounce gradient all-reduce of one sharded render over the
    process group ``group`` (the ranks of ``grad_psum_axes``; None for a
    group of one rank): :meth:`launch` starts an asynchronous SUM of one
    bounce's scene cotangents, :meth:`collect` waits for every launched
    one and returns their sums. The result is a single all-reduce of the
    summed gradient up to float32 association."""

    def __init__(self, group=None):
        self.group = group
        self._pending = []  # (work or None, flat buffer)

    def launch(self, grads) -> None:
        flat = torch.cat([g.reshape(-1) for g in grads])
        work = (dist.all_reduce(flat, group=self.group, async_op=True)
                if self.group is not None else None)
        self._pending.append((work, flat))

    def collect(self, like) -> list:
        """The summed cotangents, shaped as the leading tensors of ``like``
        that the bounces launched (zeros for the rest), after waiting for
        every launched all-reduce."""
        total = None
        for work, flat in self._pending:
            if work is not None:
                work.wait()
            total = flat if total is None else total + flat
        self._pending.clear()
        out, off = [], 0
        for x in like:
            k = x.numel()
            out.append(total[off:off + k].view_as(x) if total is not None and off < total.numel()
                       else torch.zeros_like(x))
            off += k
        return out


class _OverlappedBounce(torch.autograd.Function):
    """One bounce, ``step(leaves, state) -> state``, whose backward
    recomputes the bounce's VJP, hands the scene leaves' cotangents to a
    :class:`GradPsum` (returned to autograd as None; the scene input
    collects them) and returns the state's cotangents."""

    @staticmethod
    def forward(ctx, step, psum, n_leaves, *inputs):
        ctx.step, ctx.psum, ctx.n_leaves = step, psum, n_leaves
        ctx.save_for_backward(*inputs)
        with torch.no_grad():
            out = step(inputs[:n_leaves], inputs[n_leaves:])
        # a state entry passed through unchanged is a new tensor to autograd
        out = tuple(o.clone() if any(o is x for x in inputs) else o for o in out)
        ctx.mark_non_differentiable(*[o for o in out if not o.is_floating_point()])
        return out

    @staticmethod
    def backward(ctx, *g_out):
        n = ctx.n_leaves
        saved = ctx.saved_tensors
        leaves = [x.detach().requires_grad_(True) for x in saved[:n]]
        state = [x.detach().requires_grad_(x.is_floating_point()
                                           and ctx.needs_input_grad[3 + n + i])
                 for i, x in enumerate(saved[n:])]
        with torch.enable_grad():
            out = ctx.step(leaves, state)
        pairs = [(o, g) for o, g in zip(out, g_out) if o.requires_grad and g is not None]
        wrt = leaves + [x for x in state if x.requires_grad]
        grads = (torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                     allow_unused=True) if pairs else [None] * len(wrt))
        ctx.psum.launch([torch.zeros_like(x) if g is None else g
                         for x, g in zip(leaves, grads[:n])])
        it = iter(grads[n:])
        state_grads = [next(it) if x.requires_grad else None for x in state]
        return (None, None, None, *([None] * n), *state_grads)


def trace(scene: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
          pixel_ids: torch.Tensor, sample_ids: torch.Tensor, background, max_depth: int,
          seed, hit_fn: HitFn = closest_hit_brute, mode: str = "scan", remat: bool = True,
          active0=None, grad_psum: Optional[GradPsum] = None):
    """Trace a batch of rays (o, d (B, 3), time (B,), pixel and sample ids
    (B,) i32 as the RNG identity) to completion.

    Returns ``(radiance (B, 3), segments)``, ``segments`` a 0-d int64
    tensor on the rays' device (as ``trace_megakernel``'s, so a captured
    CUDA graph can run the trace): the ray-scene queries actually traced.
    Rays still alive after ``max_depth`` bounces add nothing more.

    ``grad_psum``: when autograd records and some scene tensor requires
    grad, each bounce runs as one :class:`_OverlappedBounce` whose
    backward gives that bounce's scene cotangent to ``grad_psum`` (and
    recomputes the bounce, so ``remat`` has no further effect); nothing
    changes without it."""
    if mode not in ("scan", "while"):
        raise ValueError(f"mode must be 'scan' or 'while', got {mode!r}")
    refuse_media(scene, "the wavefront integrator")
    background = torch.as_tensor(background, dtype=torch.float32, device=o.device)
    state = initial_state(o, d, time, pixel_ids, sample_ids, active0)
    leaves = ({p: v for p, v in float_leaves(scene) if v.requires_grad}
              if grad_psum is not None and torch.is_grad_enabled() else {})
    for bounce in range(max_depth):
        if mode == "while" and not bool(state[7].any()):
            break
        if leaves:
            def step(lv, st, b=bounce):
                sc = with_leaves(scene, dict(zip(leaves, lv)))
                return _bounce_once(sc, background, seed, hit_fn, tuple(st), b)

            state = _OverlappedBounce.apply(step, grad_psum, len(leaves), *leaves.values(),
                                            *state)
            continue
        state = run_bounce(
            lambda st, b=bounce: _bounce_once(scene, background, seed, hit_fn, st, b),
            state, remat and mode == "scan")
    return state[5], state[8]
