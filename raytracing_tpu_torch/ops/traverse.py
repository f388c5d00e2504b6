"""Stackless lockstep BVH traversal in plain PyTorch, the counterpart of
``raytracing_tpu.ops.traverse``.

Every ray of the batch walks the flattened skip-link BVH (ops/bvh.py) in
lockstep: each iteration, every live ray fetches its current node (a
gather), slab-tests the node's box against its ``(t_min, t_best)``
interval, intersects the leaf primitive if any, and advances through the
hit/miss links. ``t_best`` shrinks monotonically, giving the closest-so-far
pruning of the reference's recursive traversal
(src/accelerator/bvh_node.hpp:83-90) without recursion or stacks.

The walk ends when every ray's node is -1; divergence costs iterations
(the longest walk of the batch), not correctness. A dead ray's node stays
-1, so iterations past its end change nothing: on the card the walk asks
the host whether any ray lives only every :data:`CHECK_EVERY` iterations
(each ask is a host sync). The megakernels (K1, K5) carry their own walk
of a chunked BVH; this one is the integrator's.

Candidate roots use the brute-force sweep's arithmetic
(``ops.intersect.sphere_ts``/``quad_ts``: the same sums, ``sqrt_rn`` and
moving centres), so a ray's winner and its ``t`` are the brute-force
ones, bit for bit, except at exact ties (brute keeps the lowest id, the
walk the first it meets).
"""
from __future__ import annotations

import torch

from ..core import interval as iv
from ..core import vecmath as vm
from ..scene.types import Scene
from .intersect import (BIG, PARALLEL_EPS, T_MIN, HitBatch, hit_attributes, quad_plane_basis,
                        safe_sqrt_rn)

_DIR_EPS = 1e-20  # clamp for axis-parallel slab reciprocals
CHECK_EVERY = 16  # walk iterations between two live-ray checks on the card

# walk counters: calls of closest_hit_bvh, walk iterations, host syncs
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


def _traverse(scene: Scene, o, d, time, t_min, t_max):
    """The lockstep skip-link walk; returns (best_prim (B,) i64, t_best (B,))."""
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
        improve = is_leaf & box_hit & (t_prim < t_best)
        t_best = torch.where(improve, t_prim, t_best)
        best_prim = torch.where(improve, prim, best_prim)
        nxt = torch.where(box_hit & ~is_leaf, ni + 1, miss)
        node = torch.where(live, nxt, node)
    stats["iterations"] += it
    return best_prim, t_best


def closest_hit_bvh(scene: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                    t_min: float = T_MIN, t_max: float = BIG) -> HitBatch:
    """Closest hit by the lockstep skip-link walk of ``scene.bvh``.

    The walk runs under ``torch.no_grad()`` on detached inputs: which
    primitive wins is a discrete decision with no useful derivative. The
    winner's ``t`` and hit attributes are then recomputed with autograd,
    so gradients flow to geometry and material parameters as in the
    brute-force path."""
    if scene.bvh is None:
        raise ValueError("scene was compiled without a BVH")
    stats["calls"] += 1
    with torch.no_grad():
        best_prim, _ = _traverse(scene, o.detach(), d.detach(), time.detach(), t_min, t_max)
    # the winner's t with autograd (the same nearest-valid-root selection;
    # the unclipped upper bound picks the identical root)
    n_sph = scene.n_spheres
    is_quad = best_prim >= n_sph
    t_s = _sphere_t(scene, torch.clamp(best_prim, 0, n_sph - 1), o, d, time, t_min, BIG)
    t_q = _quad_t(scene, quad_plane_basis(scene.quads),
                  torch.clamp(best_prim - n_sph, 0, scene.n_quads - 1), o, d, t_min, BIG)
    t_final = torch.where(best_prim >= 0, torch.where(is_quad, t_q, t_s), BIG)
    return hit_attributes(scene, o, d, time, t_final, torch.clamp(best_prim, min=0))
