"""The integrator's closest hit by the scene's skip-link BVH, the
counterpart of ``raytracing_tpu.ops.traverse``.

Every ray walks the flattened skip-link BVH (ops/bvh.py) from node 0: at
each node it slab-tests the node's box against its ``(t_min, t_best)``
interval, intersects the leaf primitive if any, and advances through the
hit/miss links, until its node is -1. ``t_best`` shrinks monotonically,
giving the closest-so-far pruning of the reference's recursive traversal
(src/accelerator/bvh_node.hpp:83-90) without recursion or stacks.

:func:`walk` runs it. On CUDA tensors it launches ``rt_bvh_walk``
(``csrc/bvh_walk.cu``), a hand-written kernel that walks one ray a thread
in one launch with no host read, so a captured launch program
(``render/graphs.py``) holds it; each launch adds one to
:data:`launches`. On CPU tensors it runs the plain version,
:func:`_traverse`, which steps every ray of the batch in lockstep, as the
JAX package's ``lax.while_loop`` does: a ray's walk depends only on its
own inputs and the BVH, and a dead ray's node stays -1, so both visit the
same nodes in the same order and give the same winner and ``t``, bit for
bit. Run on the card as the kernel's reference, the plain walk asks the
host whether any ray lives every :data:`CHECK_EVERY` iterations (each ask
is a host sync). The megakernels (K1, K5) carry their own walk of a
chunked BVH; this one is the integrator's.

Candidate roots use the brute-force sweep's arithmetic
(``ops.intersect.sphere_ts``/``quad_ts``: the same sums, ``sqrt_rn`` and
moving centres), so a ray's winner and its ``t`` are the brute-force
ones, bit for bit, except at exact ties (brute keeps the lowest id, the
walk the first it meets).
"""
from __future__ import annotations

import torch

from .. import _kernels
from ..core import interval as iv
from ..core import vecmath as vm
from ..scene.types import Scene
from .intersect import (BIG, PARALLEL_EPS, T_MIN, HitBatch, hit_attributes, quad_plane_basis,
                        safe_sqrt_rn)

_DIR_EPS = 1e-20  # clamp for axis-parallel slab reciprocals
CHECK_EVERY = 16  # the plain walk's iterations between two live-ray checks on the card

launches = _kernels.LaunchCount()  # rt_bvh_walk launches (plain-version calls excluded)
# counters: calls of closest_hit_bvh, the plain walk's iterations and host syncs
stats = dict(calls=0, iterations=0, syncs=0)


def reset_stats():
    for k in stats:
        stats[k] = 0


def _slab_test(o, inv_d, bmin, bmax, t_lo, t_hi):
    """AABB slab test (reference aabb.hpp:61-112): intersect the per-axis
    [t0, t1] intervals with [t_lo, t_hi] (``t_lo`` a number, ``t_hi`` per
    ray); hit iff the result is non-empty (strict, matching
    ``if (max <= min) return false``)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    enter = torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=t_lo)
    exit_ = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), t_hi)
    return enter < exit_


def _sphere_t(scene: Scene, sid, o, d, time, t_lo, t_hi):
    """Candidate t of one sphere per ray (sphere.hpp:47-80), +inf on a
    miss: ``sphere_ts``' arithmetic on a (B,) column."""
    sph = scene.spheres
    c = sph.center[sid]
    if scene.flags.has_moving:  # as sphere_centers_at
        c = c + time[:, None] * sph.velocity[sid]
    r = sph.radius[sid]
    ocx, ocy, ocz = o[:, 0] - c[:, 0], o[:, 1] - c[:, 1], o[:, 2] - c[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    a = vm.length_squared(d)
    half_b = ocx * dx + ocy * dy + ocz * dz
    cq = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r
    disc = half_b * half_b - a * cq
    sqrtd = safe_sqrt_rn(disc)
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    ok0 = iv.surrounds(t_lo, t_hi, root0)  # open-interval root test
    ok1 = iv.surrounds(t_lo, t_hi, root1)
    root = torch.where(ok0, root0, root1)
    hit = (disc >= 0.0) & (ok0 | ok1) & (r > 0.0)
    return torch.where(hit, root, BIG)


def _quad_t(scene: Scene, basis, qid, o, d, t_lo, t_hi):
    """Candidate t of one quad per ray (quad.hpp:44-94), +inf on a miss:
    ``quad_ts``' arithmetic on a (B,) column. ``basis`` is
    ``quad_plane_basis(scene.quads)``."""
    qd = scene.quads
    normal_all, dconst_all, w_all, degen_all = basis
    n, w = normal_all[qid], w_all[qid]
    q, u, v = qd.q[qid], qd.u[qid], qd.v[qid]
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    denom = nx * dx + ny * dy + nz * dz
    safe_denom = torch.where(torch.abs(denom) < PARALLEL_EPS, 1.0, denom)
    n_dot_o = nx * ox + ny * oy + nz * oz
    t = (dconst_all[qid] - n_dot_o) / safe_denom
    px, py, pz = ox + t * dx - q[:, 0], oy + t * dy - q[:, 1], oz + t * dz - q[:, 2]
    ux, uy, uz = u[:, 0], u[:, 1], u[:, 2]
    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    alpha = wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz) + wz * (px * vy - py * vx)
    beta = wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz) + wz * (ux * py - uy * px)
    hit = ((torch.abs(denom) >= PARALLEL_EPS) & ~degen_all[qid]
           & iv.surrounds(t_lo, t_hi, t)
           & iv.contains(0.0, 1.0, alpha) & iv.contains(0.0, 1.0, beta))
    return torch.where(hit, t, BIG)


def _traverse(scene: Scene, o, d, time, t_min, t_max, counts=None):
    """The plain walk, every ray in lockstep: (best_prim (B,) i64, t_best
    (B,) f32). ``counts``, a (3, B) int64 tensor, receives each ray's node
    visits (slab tests), sphere tests and quad tests."""
    bvh = scene.bvh
    n_sph, n_quad = scene.n_spheres, scene.n_quads
    B, dev = o.shape[0], o.device
    basis = quad_plane_basis(scene.quads)
    box = torch.cat([bvh.bbox_min, bvh.bbox_max], dim=1)        # (K, 6)
    links = torch.stack([bvh.prim, bvh.miss], dim=1).long()     # (K, 2)
    leaves = links[:, 0]
    # which primitive kinds have leaves: one host read a call
    has_sph, has_quad = (bool(x) for x in torch.stack(
        [(leaves >= 0) & (leaves < n_sph), leaves >= n_sph]).any(dim=1).cpu())

    d_safe = torch.where(torch.abs(d) < _DIR_EPS,
                         torch.where(d < 0, -_DIR_EPS, _DIR_EPS), d)
    inv_d = 1.0 / d_safe
    node = torch.zeros(B, dtype=torch.long, device=dev)
    t_best = torch.full((B,), float(t_max), dtype=torch.float32, device=dev)
    best_prim = torch.full((B,), -1, dtype=torch.long, device=dev)
    check_every = CHECK_EVERY if o.is_cuda else 1
    it = 0
    while True:
        if it % check_every == 0:
            stats["syncs"] += 1
            if not bool((node >= 0).any()):
                break
        it += 1
        live = node >= 0
        ni = torch.clamp(node, min=0)
        nb = box[ni]
        box_hit = _slab_test(o, inv_d, nb[:, 0:3], nb[:, 3:6], t_min, t_best) & live
        lk = links[ni]
        prim, miss = lk[:, 0], lk[:, 1]
        is_leaf = prim >= 0
        # the leaf primitive's test, clipped to the current best: the
        # closest-so-far pruning of bvh_node.hpp:90
        if has_sph:
            t_prim = _sphere_t(scene, torch.clamp(prim, 0, n_sph - 1), o, d, time, t_min,
                               t_best)
        if has_quad:
            t_q = _quad_t(scene, basis, torch.clamp(prim - n_sph, 0, n_quad - 1), o, d,
                          t_min, t_best)
            t_prim = torch.where(prim >= n_sph, t_q, t_prim) if has_sph else t_q
        if counts is not None:
            tested = is_leaf & box_hit
            counts[0] += live
            counts[1] += tested & (prim < n_sph)
            counts[2] += tested & (prim >= n_sph)
        improve = is_leaf & box_hit & (t_prim < t_best)
        t_best = torch.where(improve, t_prim, t_best)
        best_prim = torch.where(improve, prim, best_prim)
        nxt = torch.where(box_hit & ~is_leaf, ni + 1, miss)
        node = torch.where(live, nxt, node)
    stats["iterations"] += it
    return best_prim, t_best


def kernel_args(scene: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                t_min: float, t_max: float):
    """``rt_bvh_walk``'s inputs for these rays, on their device: ``(tensors,
    args)``, where ``args`` are its arguments before the outputs and
    ``tensors`` the contiguous tensors its pointers point into (the
    caller keeps them alive until the launch)."""
    bvh, sph, qd = scene.bvh, scene.spheres, scene.quads
    B = o.shape[0]
    if o.shape != (B, 3) or d.shape != (B, 3) or time.shape != (B,):
        raise ValueError(f"the walk takes o, d (B, 3) and time (B,), got {tuple(o.shape)}, "
                         f"{tuple(d.shape)}, {tuple(time.shape)}")
    normal, dconst, w, degen = quad_plane_basis(qd)
    floats = (o, d, time, bvh.bbox_min, bvh.bbox_max, sph.center, sph.velocity, sph.radius,
              normal, dconst, w, qd.q, qd.u, qd.v)
    if (any(x.dtype != torch.float32 for x in floats) or bvh.prim.dtype != torch.int32
            or bvh.miss.dtype != torch.int32):
        raise ValueError("the walk takes float32 rays and scene, and int32 BVH links")
    if any(x.device != o.device for x in (*floats, bvh.prim, bvh.miss)):
        raise ValueError("the rays and the scene must be on one device")
    if B >= 2 ** 31 or bvh.prim.shape[0] >= 2 ** 31:
        raise ValueError(f"a walk of {B} rays over {bvh.prim.shape[0]} nodes exceeds its "
                         f"32-bit indexing")
    o, d, time, bmin, bmax, c, v, r, n, dc, w, q, u, qv = (
        x.detach().contiguous() for x in floats)
    degen, prim, miss = degen.contiguous(), bvh.prim.contiguous(), bvh.miss.contiguous()
    tensors = (o, d, time, bmin, bmax, prim, miss, c, v, r, n, dc, w, degen, q, u, qv)
    args = (o.data_ptr(), d.data_ptr(), time.data_ptr(), B, bmin.data_ptr(), bmax.data_ptr(),
            prim.data_ptr(), miss.data_ptr(), prim.shape[0], c.data_ptr(), v.data_ptr(),
            r.data_ptr(), scene.n_spheres, n.data_ptr(), dc.data_ptr(), w.data_ptr(),
            degen.data_ptr(), q.data_ptr(), u.data_ptr(), qv.data_ptr(), float(t_min),
            float(t_max), int(scene.flags.has_moving))
    return tensors, args


def walk(scene: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
         t_min: float = T_MIN, t_max: float = BIG):
    """The walk of ``scene.bvh`` for rays ``o, d (B, 3)`` f32 at ``time
    (B,)``: (best_prim (B,) i64, -1 on a miss; t_best (B,) f32, ``t_max``
    on a miss). CPU tensors run the plain version; CUDA tensors launch
    ``rt_bvh_walk``, or raise. No gradient flows through it."""
    dev = o.device
    if dev.type == "cpu":
        return _traverse(scene, o, d, time, t_min, t_max)
    if dev.type != "cuda":
        raise ValueError(f"the BVH walk runs on CUDA tensors (kernel) or CPU tensors (plain "
                         f"version), not {dev}")
    _alive, args = kernel_args(scene, o, d, time, t_min, t_max)  # kept until the launch
    B = o.shape[0]
    best_prim = torch.empty(B, dtype=torch.int64, device=dev)
    t_best = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return best_prim, t_best
    lib = _kernels.library().lib
    with torch.cuda.device(dev):
        err = lib.rt_bvh_walk(*args, best_prim.data_ptr(), t_best.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    launches.add(dev)
    if err != 0:
        raise RuntimeError(f"rt_bvh_walk launch failed: {lib.rt_error_string(err).decode()}")
    return best_prim, t_best


def closest_hit_bvh(scene: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                    t_min: float = T_MIN, t_max: float = BIG) -> HitBatch:
    """Closest hit by the lockstep skip-link walk of ``scene.bvh``.

    The walk (:func:`walk`: the kernel on the card, the plain version on
    the CPU) runs under ``torch.no_grad()`` on detached inputs: which
    primitive wins is a discrete decision with no useful derivative. The
    winner's ``t`` and hit attributes are then recomputed with autograd,
    so gradients flow to geometry and material parameters as in the
    brute-force path."""
    if scene.bvh is None:
        raise ValueError("scene was compiled without a BVH")
    stats["calls"] += 1
    with torch.no_grad():
        best_prim, _ = walk(scene, o.detach(), d.detach(), time.detach(), t_min, t_max)
    # the winner's t with autograd (the same nearest-valid-root selection;
    # the unclipped upper bound picks the identical root)
    n_sph = scene.n_spheres
    is_quad = best_prim >= n_sph
    t_s = _sphere_t(scene, torch.clamp(best_prim, 0, n_sph - 1), o, d, time, t_min, BIG)
    t_q = _quad_t(scene, quad_plane_basis(scene.quads),
                  torch.clamp(best_prim - n_sph, 0, scene.n_quads - 1), o, d, t_min, BIG)
    t_final = torch.where(best_prim >= 0, torch.where(is_quad, t_q, t_s), BIG)
    return hit_attributes(scene, o, d, time, t_final, torch.clamp(best_prim, min=0))
