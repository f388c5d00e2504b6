"""Ring scene-shard closest hit, the counterpart of
``raytracing_tpu/parallel/ring.py:39-124``: blocks of rays travel around
the ``tp`` ring (``batch_isend_irecv`` to the next rank, from the
previous one, where JAX has ``lax.ppermute``) while each rank keeps its
primitive range.

Two passes of ``ntp`` steps:

1. closest hit: the block (rays, best t, best global id) visits every
   rank and is tested against each range, the running minimum carried
   with the rays (the reference's ``closest_so_far``);
2. attribute fill: the winning (t, id) goes round again, and the rank
   that owns the winner writes the hit record into the block.

After ``ntp`` steps every block is home. The hits are those of the
all-reduce path (``scene_shard.py``). Send/recv needs gloo on CPU tensors
or NCCL with a card a rank (``mesh.py``). Gradients flow back around the
ring (the shift's backward sends the other way).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.intersect import BIG, T_MIN, HitBatch, hit_attributes, quad_ts, sphere_ts
from ..scene.types import Scene
from .mesh import Mesh
from .scene_shard import INT_MAX, _global_ids


def _exchange(xs, to: int, frm: int, group):
    """Send every tensor of ``xs`` to rank ``to`` and receive the same
    shapes from rank ``frm`` (global ranks), in one batch."""
    recv = [torch.empty_like(x) for x in xs]
    ops = [dist.P2POp(dist.isend, x.contiguous(), to, group) for x in xs]
    ops += [dist.P2POp(dist.irecv, r, frm, group) for r in recv]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


class _Shift(torch.autograd.Function):
    """One ring step of a tuple of tensors; its backward shifts the
    cotangents of the floating-point ones the other way (zeros where a
    rank has none, so both sides of every exchange agree)."""

    @staticmethod
    def forward(ctx, nxt, prv, group, *xs):
        ctx.nxt, ctx.prv, ctx.group = nxt, prv, group
        ctx.like = [x if x.is_floating_point() else None for x in xs]
        out = _exchange(xs, nxt, prv, group)
        ctx.mark_non_differentiable(*[o for o in out if not o.is_floating_point()])
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        pos = [k for k, x in enumerate(ctx.like) if x is not None]
        send = [torch.zeros_like(ctx.like[k]) if gs[k] is None else gs[k] for k in pos]
        out = [None] * len(gs)
        for k, g in zip(pos, _exchange(send, ctx.prv, ctx.nxt, ctx.group)):
            out[k] = g
        return (None, None, None, *out)


def _shift(xs, mesh: Mesh, axis: str):
    nxt, prv = mesh.peer(axis, 1), mesh.peer(axis, -1)
    group = mesh.group(axis)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return _Shift.apply(nxt, prv, group, *xs)
    return _exchange(xs, nxt, prv, group)


def closest_hit_ring(scene_local: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                     t_min: float = T_MIN, *, mesh: Mesh, axis: str = "tp") -> HitBatch:
    """Closest hit with the primitives split over the ``axis`` ring; global
    ids as in ``scene_shard.py``."""
    ntp, my = mesh.size(axis), mesh.index(axis)
    ns_local, nq_local = scene_local.n_spheres, scene_local.n_quads
    ns_total = ns_local * ntp
    B, dev = o.shape[0], o.device

    # pass 1: the rays go round carrying their best (t, id)
    t_best = torch.full((B,), BIG, dtype=torch.float32, device=dev)
    gid_best = torch.full((B,), INT_MAX, dtype=torch.int32, device=dev)
    block = [o, d, time, t_best, gid_best]
    for _ in range(ntp):
        o_c, d_c, tm_c, tb, gb = block
        cap = tb.detach()
        all_t = torch.cat([sphere_ts(scene_local, o_c, d_c, tm_c, t_min, cap),
                           quad_ts(scene_local, o_c, d_c, t_min, cap)], dim=1)
        best = torch.argmin(all_t, dim=1)
        t_loc = torch.gather(all_t, 1, best[:, None])[:, 0]
        gid_loc = torch.where(torch.isfinite(t_loc),
                              _global_ids(best, my, ns_local, nq_local, ntp).to(torch.int32),
                              INT_MAX)
        better = t_loc.detach() < cap
        tb = torch.where(better, t_loc, tb)
        gb = torch.where(better, gid_loc, gb)
        block = _shift([o_c, d_c, tm_c, tb, gb], mesh, axis)
    o_c, d_c, tm_c, t_best, gid_best = block

    # pass 2: the owner of each winner fills the record
    f = torch.zeros((B, 10), dtype=torch.float32, device=dev)  # t p normal ff u v
    f[:, 0] = BIG
    i = torch.stack([torch.zeros(B, dtype=torch.int32, device=dev),          # valid
                     torch.zeros(B, dtype=torch.int32, device=dev),          # mat_id
                     torch.full((B,), -1, dtype=torch.int32, device=dev)],   # prim_id
                    dim=1)
    block2 = [o_c, d_c, tm_c, t_best, gid_best, f, i]
    sph_lo, quad_lo = my * ns_local, ns_total + my * nq_local
    for _ in range(ntp):
        o_c, d_c, tm_c, tb, gb, f, i = block2
        is_sph = (gb >= sph_lo) & (gb < sph_lo + ns_local)
        is_quad = (gb >= quad_lo) & (gb < quad_lo + nq_local)
        mine = is_sph | is_quad
        local_idx = torch.where(is_quad, ns_local + (gb - quad_lo), gb - sph_lo)
        local_idx = torch.clamp(local_idx, 0, ns_local + nq_local - 1)
        h = hit_attributes(scene_local, o_c, d_c, tm_c, torch.where(mine, tb, BIG), local_idx)
        new_f = torch.cat([h.t[:, None], h.p, h.normal, h.front_face.float()[:, None],
                           h.u[:, None], h.v[:, None]], dim=1)
        f = torch.where(mine[:, None], new_f, f)
        new_i = torch.stack([h.valid.to(torch.int32), h.mat_id.to(torch.int32),
                             torch.where(h.valid, gb, -1)], dim=1)
        i = torch.where(mine[:, None], new_i, i)
        block2 = _shift([o_c, d_c, tm_c, tb, gb, f, i], mesh, axis)
    f, i = block2[5], block2[6]
    valid = i[:, 0] > 0
    return HitBatch(valid=valid, t=f[:, 0], p=f[:, 1:4], normal=f[:, 4:7],
                    front_face=f[:, 7] > 0, u=f[:, 8], v=f[:, 9], mat_id=i[:, 1],
                    prim_id=i[:, 2])
