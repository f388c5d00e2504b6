"""Scene-sharded ("tensor parallel") closest hit, the counterpart of
``raytracing_tpu/parallel/scene_shard.py``: the primitives are split by
range across the ``tp`` ranks, each rank intersects every ray with its
own range, and the global closest hit is found with two MIN all-reduces,
of t and then of the global primitive id (the lowest id wins a tie, as
the brute-force argmin does); the winning rank contributes its hit
record and the others zeros, summed by an all-reduce. Materials and
textures stay whole on every rank.

The winner's selection is discrete and detached; the record's masked sums
are differentiable (``mesh.psum``), so gradients reach the winning
rank's geometry. The render (``shard.py``) hands each rank its own range
of the tables ``shard_scene_primitives`` pads and orders.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import bvh as bvh_mod
from ..ops.intersect import BIG, T_MIN, HitBatch, hit_attributes, quad_ts, sphere_ts
from ..scene.types import BVH, Scene
from .mesh import Mesh, pmin, psum

INT_MAX = 2**31 - 1  # the candidate id of a rank with no hit


def _global_ids(local: torch.Tensor, idx: int, ns_local: int, nq_local: int,
                ntp: int) -> torch.Tensor:
    """Local primitive ids → global: rank k's sphere i → k·ns_local + i,
    its quad j → ns_total + k·nq_local + j
    (``raytracing_tpu/parallel/scene_shard.py:36-38``)."""
    return torch.where(local >= ns_local,
                       ns_local * ntp + idx * nq_local + (local - ns_local),
                       idx * ns_local + local)


def _reduce_winner(hit_local: HitBatch, local_t: torch.Tensor, global_id: torch.Tensor,
                   mesh: Mesh, axis: str) -> HitBatch:
    """The global closest hit from each rank's best (t, global id): MIN of
    t, then MIN of the id among the ranks at that t, then the winner's
    record summed with every other rank's zeros."""
    local_t = local_t.detach()
    t_glob = pmin(local_t, mesh, axis)
    candidate = torch.where((local_t == t_glob) & torch.isfinite(local_t),
                            global_id.to(torch.int32), INT_MAX)
    gid = pmin(candidate, mesh, axis)
    win = (candidate == gid) & (gid != INT_MAX)
    w1 = win[:, None]
    floats = torch.cat([torch.where(win, hit_local.t, 0.0)[:, None],
                        torch.where(w1, hit_local.p, 0.0), torch.where(w1, hit_local.normal, 0.0),
                        torch.where(win, hit_local.front_face.float(), 0.0)[:, None],
                        torch.where(win, hit_local.u, 0.0)[:, None],
                        torch.where(win, hit_local.v, 0.0)[:, None]], dim=1)
    ints = torch.stack([win.to(torch.int32), torch.where(win, hit_local.mat_id, 0)], dim=1)
    floats = psum(floats, mesh, axis)
    ints = psum(ints, mesh, axis)
    valid = ints[:, 0] > 0
    return HitBatch(valid=valid, t=torch.where(valid, floats[:, 0], BIG), p=floats[:, 1:4],
                    normal=floats[:, 4:7], front_face=floats[:, 7] > 0, u=floats[:, 8],
                    v=floats[:, 9], mat_id=ints[:, 1], prim_id=torch.where(valid, gid, -1))


def closest_hit_scene_sharded(scene_local: Scene, o: torch.Tensor, d: torch.Tensor,
                              time: torch.Tensor, t_min: float = T_MIN, *, mesh: Mesh,
                              axis: str = "tp") -> HitBatch:
    """Closest hit where ``scene_local`` holds this rank's primitive range
    (``raytracing_tpu/parallel/scene_shard.py:27-95``): a brute-force
    sweep of the range, then the winner across ranks."""
    idx, ntp = mesh.index(axis), mesh.size(axis)
    ns_local, nq_local = scene_local.n_spheres, scene_local.n_quads
    all_t = torch.cat([sphere_ts(scene_local, o, d, time, t_min, BIG),
                       quad_ts(scene_local, o, d, t_min, BIG)], dim=1)
    local_best = torch.argmin(all_t, dim=1)
    local_t = torch.gather(all_t, 1, local_best[:, None])[:, 0]
    gid_local = _global_ids(local_best, idx, ns_local, nq_local, ntp)
    # the record of this rank's best; the winner's is kept by the reduction
    hit_local = hit_attributes(scene_local, o, d, time, local_t, local_best.to(torch.int32))
    return _reduce_winner(hit_local, local_t, gid_local, mesh, axis)


def closest_hit_scene_sharded_bvh(scene_local: Scene, o: torch.Tensor, d: torch.Tensor,
                                  time: torch.Tensor, t_min: float = T_MIN, *, mesh: Mesh,
                                  axis: str = "tp") -> HitBatch:
    """Sharded closest hit where each rank walks its own BVH over its range
    (``shard_scene_primitives(..., use_bvh=True)``;
    ``raytracing_tpu/parallel/scene_shard.py:97-161``), on the port's
    ``ops/traverse.closest_hit_bvh``; the winner reduction is the
    brute-force variant's."""
    from ..ops.traverse import closest_hit_bvh

    idx, ntp = mesh.index(axis), mesh.size(axis)
    hit_local = closest_hit_bvh(scene_local, o, d, time, t_min)
    local_t = torch.where(hit_local.valid, hit_local.t, BIG)
    gid_local = _global_ids(hit_local.prim_id.long(), idx, scene_local.n_spheres,
                            scene_local.n_quads, ntp)
    return _reduce_winner(hit_local, local_t, gid_local, mesh, axis)


def _morton_order(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    """Primitive order by the Morton code of their box centres (10 bits an
    axis), stable."""
    if len(mn) == 0:
        return np.arange(0)
    mid = (mn + mx) / 2
    lo = mid.min(axis=0)
    span = np.maximum(mid.max(axis=0) - lo, 1e-30)
    q = np.clip(((mid - lo) / span * 1023.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    key = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(key, kind="stable")


def _pad_rows(x: torch.Tensor, mult: int) -> torch.Tensor:
    """``x`` with zero rows appended up to a multiple of ``mult`` (a zero
    radius, or u = v = 0, is a primitive nothing hits)."""
    n = x.shape[0]
    target = -(-n // mult) * mult
    if target == n:
        return x
    return torch.cat([x, torch.zeros((target - n, *x.shape[1:]), dtype=x.dtype,
                                     device=x.device)])


def shard_scene_primitives(scene: Scene, ntp: int, use_bvh: bool = False) -> Scene:
    """The whole scene with its sphere and quad tables padded to a
    multiple of ``ntp`` rows (``raytracing_tpu/parallel/scene_shard.py:163-282``);
    rank k's range is rows ``[k·n/ntp, (k+1)·n/ntp)`` of each (``shard_of``).

    ``use_bvh=False``: each rank sweeps its range (``bvh=None``).
    ``use_bvh=True``: the primitives are first put in Morton order of
    their boxes (per type), so each range is a compact region, and one BVH
    is built over each range (``ops/bvh.py``, leaf ids local to the
    range), its nodes padded to a common length with unreachable nodes and
    stacked, ``ntp`` blocks of ``K`` rows. The reordering changes only the
    tie-break among exactly equal hit distances."""
    sph, qd = scene.spheres, scene.quads
    if use_bvh:
        def arr(x):
            return x.detach().cpu().numpy()

        smin, smax = bvh_mod.primitive_bounds(
            arr(sph.center), arr(sph.velocity), arr(sph.radius), np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
        qmin, qmax = bvh_mod.primitive_bounds(
            np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros((0,), np.float32), arr(qd.q), arr(qd.u), arr(qd.v))
        sperm = torch.from_numpy(_morton_order(smin, smax)).to(sph.radius.device)
        qperm = torch.from_numpy(_morton_order(qmin, qmax)).to(qd.mat_id.device)
        sph = type(sph)(**{f.name: getattr(sph, f.name)[sperm] for f in dataclasses.fields(sph)})
        qd = type(qd)(**{f.name: getattr(qd, f.name)[qperm] for f in dataclasses.fields(qd)})
    sph = type(sph)(**{f.name: _pad_rows(getattr(sph, f.name), ntp)
                       for f in dataclasses.fields(sph)})
    qd = type(qd)(**{f.name: _pad_rows(getattr(qd, f.name), ntp)
                     for f in dataclasses.fields(qd)})

    bvh = None
    if use_bvh:
        ns_local, nq_local = sph.radius.shape[0] // ntp, qd.mat_id.shape[0] // ntp

        def arr(x, k, n):
            return x[k * n:(k + 1) * n].detach().cpu().numpy()

        flats = [bvh_mod.build_bvh(arr(sph.center, k, ns_local), arr(sph.velocity, k, ns_local),
                                   arr(sph.radius, k, ns_local), arr(qd.q, k, nq_local),
                                   arr(qd.u, k, nq_local), arr(qd.v, k, nq_local),
                                   quad_id_offset=ns_local) for k in range(ntp)]
        kmax = max(f.prim.shape[0] for f in flats)

        def pad_nodes(f):
            padn = kmax - f.prim.shape[0]
            # unreachable (no link points past a real tree): empty boxes,
            # ending links
            return (np.pad(f.bbox_min, ((0, padn), (0, 0)), constant_values=3.0e38),
                    np.pad(f.bbox_max, ((0, padn), (0, 0)), constant_values=-3.0e38),
                    np.pad(f.prim, (0, padn), constant_values=-1),
                    np.pad(f.miss, (0, padn), constant_values=-1))

        parts = [pad_nodes(f) for f in flats]
        dev = sph.radius.device
        bvh = BVH(*(torch.from_numpy(np.concatenate([p[i] for p in parts])).to(dev)
                    for i in range(4)))
    return dataclasses.replace(scene, spheres=sph, quads=qd, bvh=bvh)


def shard_of(scene: Scene, k: int, ntp: int) -> Scene:
    """Rank ``k``'s range of a scene from :func:`shard_scene_primitives`:
    its rows of the sphere and quad tables (views, so gradients reach the
    whole tables) and its block of the stacked BVH."""
    sph, qd = scene.spheres, scene.quads
    ns, nq = sph.radius.shape[0] // ntp, qd.mat_id.shape[0] // ntp
    sph = type(sph)(**{f.name: getattr(sph, f.name)[k * ns:(k + 1) * ns]
                       for f in dataclasses.fields(sph)})
    qd = type(qd)(**{f.name: getattr(qd, f.name)[k * nq:(k + 1) * nq]
                     for f in dataclasses.fields(qd)})
    bvh = scene.bvh
    if bvh is not None:
        kk = bvh.prim.shape[0] // ntp
        bvh = BVH(*(getattr(bvh, f.name)[k * kk:(k + 1) * kk] for f in dataclasses.fields(bvh)))
    return dataclasses.replace(scene, spheres=sph, quads=qd, bvh=bvh)
