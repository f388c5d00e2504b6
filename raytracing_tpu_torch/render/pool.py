"""The regenerating-pool schedule, the counterpart of
``raytracing_tpu.render.pool``: the whole render as one persistent
wavefront of P rays, each lane refilled with a fresh camera ray as soon as
its path ends.

* Every iteration launches K1 for ``K_BOUNCES`` bounces in its depth-cap
  mode: each ray carries its own depth ``dep``, which continues its RNG
  stream at bounce ``dep + b`` and ends its path after ``max_depth``
  segments. So every path is bit-identical to the phased schedule's.
* The pool is then partitioned by one sort on a key: dead rays first, by
  ``gid`` (``gid = sample · n_pix + pixel`` below 2^24), then the lanes
  already empty (``2^24 + lane``), then the live rays (``2^25 + lane``).
  ``gid`` and ``dep`` travel packed in one int32 (``dep · 2^24 + gid``).
* The dead rays' radiance is written straight to its gid's row
  (``index_copy_``, unique indices). The JAX package also offers a
  death-order log restored to stream order by one final sort, for TPUs,
  where scatters are slow; on the card that banking takes twice the
  scatter's time (``tools/time_pool_fold.py``), so the port has only the
  scatter.
* The freed prefix is refilled with the next gids of the stream:
  ``pix = g % n_pix``, ``smp = sample_start + g // n_pix``, their camera
  rays from ``render/camera.py`` (the same streams as the phased path's).
  Lanes past the stream stay empty.

The JAX package runs this as one compiled ``while_loop``; here it is a
host loop that reads the partition's counts back once per iteration,
for the loop condition and the refill's size. The sorts, gathers and
scatters are PyTorch's: glue around the kernel, as XLA's were.

Each path's radiance equals the phased path's; the per-pixel sum over
samples may add in another order, so images agree to an ulp or so.
"""
from __future__ import annotations

import torch

from ..ops import megakernel_block as mb
from ..ops.megakernel import BLOCK, pack_rays
from . import camera as cam_mod
from .camera import CameraConfig, CameraParams

# gids must stay below 2^24 for the sort key; longer
# streams are split into sample windows by the caller (Renderer does this)
MAX_POOL_STREAM = 1 << 24
GID_BITS = 24
# dep shares an int32 with the gid above its 24 bits
MAX_POOL_DEPTH = 64
K_BOUNCES = 2  # bounces per K1 launch, the JAX package's default
POOL_SIZE = 1 << 18  # lanes, the JAX package's default


def trace_pool(mega, cfg: CameraConfig, params: CameraParams, seed: int, *,
               pool_size: int = POOL_SIZE, sample_start: int = 0, n_samples=None,
               motion_blur: bool = True, cull=None):
    """Trace ``cfg.n_pixels × n_samples`` paths (samples ``sample_start``
    on) through the pool. Returns ``(radiance summed over the samples
    (n_pix, 3) f32, segments)``, ``segments`` an int64 0-d tensor, both on
    the scene's device. ``cull`` is K1's search (``mb.trace_block``)."""
    P = pool_size
    n_pix = cfg.n_pixels
    spp = cfg.samples_per_pixel if n_samples is None else n_samples
    total = n_pix * spp
    if P <= 0 or P % BLOCK:
        raise ValueError(f"pool size must be a positive multiple of {BLOCK}, got {P}")
    if total >= MAX_POOL_STREAM:
        raise ValueError(f"a pool stream of {total} paths needs gids of more than "
                         f"{GID_BITS} bits: split the samples into windows")
    if cfg.max_depth >= MAX_POOL_DEPTH:
        raise ValueError(f"max_depth {cfg.max_depth}: the pool packs a ray's depth in "
                         f"{32 - GID_BITS} bits above its gid (below {MAX_POOL_DEPTH})")
    dev = mega.sph_sweep.device
    derived = cam_mod.derive(cfg, params)
    lane = torch.arange(P, dtype=torch.int32, device=dev)

    def fresh(gid):
        """K1's packed state for new camera rays of stream positions ``gid``."""
        pix = gid % n_pix
        smp = sample_start + torch.div(gid, n_pix, rounding_mode="floor")
        o, d, tm = cam_mod.generate_rays(cfg, derived, pix, smp, seed, motion_blur=motion_blur)
        return pack_rays(o, d, tm, pix, smp)

    n_fill = min(P, total)
    ray_f = torch.zeros((mb.N_F, P), dtype=torch.float32, device=dev)
    ray_i = torch.zeros((2, P), dtype=torch.int32, device=dev)
    ray_f[:, :n_fill], ray_i[:, :n_fill] = fresh(lane[:n_fill])
    gid = torch.where(lane < total, lane, total)  # empty lanes hold the sentinel total
    dep = torch.zeros(P, dtype=torch.int32, device=dev)
    next_gid = n_fill
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    acc = torch.empty((total, 3), dtype=torch.float32, device=dev)  # radiance by gid
    banked = 0

    while True:
        _, bc, state = mb.trace_block(mega, ray_f, ray_i, seed, 0, max_depth=K_BOUNCES,
                                      background=cfg.background, depth_cap=cfg.max_depth,
                                      dep=dep, cull=cull)
        segments = segments + bc.sum()
        alive = state[mb.ACT] > 0.0
        key = torch.where(alive, (1 << 25) + lane,
                          torch.where(gid >= total, (1 << 24) + lane, gid))
        packed = (dep + bc) * (1 << GID_BITS) + gid
        n_dead, n_not_alive = (int(x) for x in torch.stack(
            [(key < (1 << 24)).sum(), (key < (1 << 25)).sum()]).tolist())
        order = torch.argsort(key)
        ray_f = state[:, order]  # its RR..RB rows are the radiance
        ray_i = ray_i[:, order]
        packed = packed[order]
        gid = packed & ((1 << GID_BITS) - 1)
        dep = packed >> GID_BITS

        # bank the dead prefix at its gids
        if n_dead:
            acc.index_copy_(0, gid[:n_dead].long(), ray_f[mb.RR:mb.RB + 1, :n_dead].T)
            banked += n_dead
        if next_gid >= total and n_not_alive == P:
            break

        # refill the freed prefix with the next gids; the rest stays empty
        n_refill = min(n_not_alive, total - next_gid)
        if n_refill:
            new = next_gid + lane[:n_refill]
            ray_f[:, :n_refill], ray_i[:, :n_refill] = fresh(new)
            gid[:n_refill] = new
            dep[:n_refill] = 0
        gid[n_refill:n_not_alive] = total
        next_gid += n_refill

    if banked != total:
        raise RuntimeError(f"pool banked {banked} paths of {total}")
    # gid = sample · n_pix + pixel: sum the sample axis
    return acc.reshape(spp, n_pix, 3).sum(dim=0), segments
