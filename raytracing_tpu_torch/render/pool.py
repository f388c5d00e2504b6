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
* The dead rays' radiance is written straight to its gid's row by one
  ``index_copy_`` over every lane, with unique indices: the other lanes
  write rows ``total + lane`` past the stream, which are never read (the
  JAX package's ``mode="drop"``). The JAX package also offers a
  death-order log restored to stream order by one final sort, for TPUs,
  where scatters are slow; on the card that banking takes twice the
  scatter's time (``tools/time_pool_fold.py``), so the port has only the
  scatter.
* The freed prefix is refilled with the next gids of the stream:
  ``pix = g % n_pix``, ``smp = sample_start + g // n_pix``, their camera
  rays from ``render/camera.py`` (the same streams as the phased path's).
  Camera rays are computed for every lane and selected where a lane is
  refilled. Lanes past the stream stay empty.

As in the JAX package's ``lax.while_loop``, every shape of an iteration
is static and every count (dead, not alive, refilled, the next gid, the
segments) is a device scalar; :meth:`Pool.step` writes the loop's
condition, ``next_gid < total or any ray alive``, into a device flag. A
:class:`~raytracing_tpu_torch.render.graphs.WhileProgram` drives it: on a
card (``fused``) one captured iteration inside a CUDA graph WHILE node,
one launch a sample window with no host read; on the CPU, or with
``fused=False``, a host loop that reads the flag once an iteration. The
sorts, gathers and scatters are PyTorch's: glue around the kernel, as
XLA's were.

Each path's radiance equals the phased path's; the per-pixel sum over
samples may add in another order, so images agree to an ulp or so.
"""
from __future__ import annotations

import torch

from ..ops import megakernel_block as mb
from ..ops.megakernel import BLOCK, pack_rays
from ..utils.profiling import stage
from . import camera as cam_mod
from . import graphs
from .camera import CameraConfig, CameraParams

# gids must stay below 2^24 for the sort key; longer
# streams are split into sample windows by the caller (Renderer does this)
MAX_POOL_STREAM = 1 << 24
GID_BITS = 24
# dep shares an int32 with the gid above its 24 bits
MAX_POOL_DEPTH = 64
K_BOUNCES = 2  # bounces per K1 launch, the JAX package's default
POOL_SIZE = 1 << 18  # lanes, the JAX package's default


class Pool:
    """The state and one iteration of a pool of ``pool_size`` lanes that
    traces ``cfg.n_pixels × n_samples`` paths (samples ``sample_start``
    on, set by :meth:`init`). Every tensor is allocated here, once, so a
    captured :meth:`step` serves every window of the same size. ``cull``
    is K1's search (``mb.trace_block``)."""

    def __init__(self, mega, cfg: CameraConfig, seed: int, *, pool_size: int = POOL_SIZE,
                 n_samples=None, motion_blur: bool = True, cull=None):
        P = pool_size
        spp = cfg.samples_per_pixel if n_samples is None else n_samples
        total = cfg.n_pixels * spp
        if P <= 0 or P % BLOCK:
            raise ValueError(f"pool size must be a positive multiple of {BLOCK}, got {P}")
        if total >= MAX_POOL_STREAM:
            raise ValueError(f"a pool stream of {total} paths needs gids of more than "
                             f"{GID_BITS} bits: split the samples into windows")
        if mega.n_media:
            raise ValueError(f"the pool's depth cap has no K1 with media, and this scene has "
                             f"{mega.n_media}: render it with schedule='phased'")
        if cfg.max_depth >= MAX_POOL_DEPTH:
            raise ValueError(f"max_depth {cfg.max_depth}: the pool packs a ray's depth in "
                             f"{32 - GID_BITS} bits above its gid (below {MAX_POOL_DEPTH})")
        self.mega, self.cfg, self.seed = mega, cfg, seed
        self.P, self.spp, self.total = P, spp, total
        self.motion_blur, self.cull = motion_blur, cull
        dev = self.device = mega.sph_sweep.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.lane = torch.arange(P, **i32)
        self.derived = graphs._owned(cam_mod.derive(cfg, CameraParams.from_config(cfg, dev)))
        self.sample_start = torch.zeros((), **i32)
        self.ray_f = torch.zeros((mb.N_F, P), dtype=torch.float32, device=dev)
        self.ray_i = torch.zeros((2, P), **i32)
        self.gid = torch.zeros(P, **i32)
        self.dep = torch.zeros(P, **i32)
        self.next_gid = torch.zeros((), **i32)
        self.segments = torch.zeros((), dtype=torch.int64, device=dev)
        self.banked = torch.zeros((), dtype=torch.int64, device=dev)
        self.iterations = torch.zeros((), dtype=torch.int64, device=dev)
        self.flag = torch.zeros((), dtype=torch.bool, device=dev)
        # radiance by gid; rows past total take the lanes that bank nothing
        self.acc = torch.empty((total + P, 3), dtype=torch.float32, device=dev)

    def _fresh(self, gid: torch.Tensor):
        """K1's packed state for new camera rays of stream positions ``gid``."""
        n_pix = self.cfg.n_pixels
        pix = gid % n_pix
        smp = self.sample_start + torch.div(gid, n_pix, rounding_mode="floor")
        o, d, tm = cam_mod.generate_rays(self.cfg, self.derived, pix, smp, self.seed,
                                         motion_blur=self.motion_blur)
        return pack_rays(o, d, tm, pix, smp)

    def init(self, params: CameraParams, sample_start: int) -> None:
        """Fill the pool with the first gids of the window that starts at
        sample ``sample_start``, seen through ``params``, and set the
        counts and the flag; reads nothing back from the device."""
        graphs._assign(self.derived, cam_mod.derive(self.cfg, params))
        self.sample_start.fill_(sample_start)
        n_fill = min(self.P, self.total)
        self.ray_f.zero_()
        self.ray_i.zero_()
        with stage("camera", self.device):
            self.ray_f[:, :n_fill], self.ray_i[:, :n_fill] = self._fresh(self.lane[:n_fill])
        # empty lanes hold the sentinel total
        torch.clamp(self.lane, max=self.total, out=self.gid)
        self.dep.zero_()
        self.next_gid.fill_(n_fill)
        for count in (self.segments, self.banked, self.iterations):
            count.zero_()
        self.flag.fill_(True)

    def step(self) -> None:
        """One iteration: K1 for ``K_BOUNCES`` bounces, the partition, the
        dead rays banked, the freed lanes refilled, the flag set. Static
        shapes, no host read. Stages (``utils.profiling``): ``k1``,
        ``compact`` (the partition and the flag), ``bank`` and ``camera``
        (the refill)."""
        P, total, lane, dev = self.P, self.total, self.lane, self.device
        with stage("k1", dev):
            _, bc, state = mb.trace_block(self.mega, self.ray_f, self.ray_i, self.seed, 0,
                                          max_depth=K_BOUNCES, background=self.cfg.background,
                                          depth_cap=self.cfg.max_depth, dep=self.dep,
                                          cull=self.cull)
        with stage("compact", dev):
            self.segments.add_(bc.sum())
            alive = state[mb.ACT] > 0.0
            key = torch.where(alive, (1 << 25) + lane,
                              torch.where(self.gid >= total, (1 << 24) + lane, self.gid))
            packed = (self.dep + bc) * (1 << GID_BITS) + self.gid
            n_dead = (key < (1 << 24)).sum()
            n_not_alive = (key < (1 << 25)).sum()
            order = torch.argsort(key)
            ray_f = state[:, order]  # its RR..RB rows are the radiance
            ray_i = self.ray_i[:, order]
            packed = packed[order]
            gid = packed & ((1 << GID_BITS) - 1)
            dep = packed >> GID_BITS
            # the loop goes on while the stream has gids left or a ray is alive
            self.flag.copy_((self.next_gid < total) | (n_not_alive < P))

        with stage("bank", dev):
            # bank the dead prefix at its gids, every other lane past the stream
            idx = torch.where(lane < n_dead, gid, total + lane)
            self.acc.index_copy_(0, idx.long(), ray_f[mb.RR:mb.RB + 1].T)
            self.banked.add_(n_dead)

        with stage("camera", dev):
            # refill the freed prefix with the next gids; the rest stays empty
            n_refill = torch.minimum(n_not_alive, total - self.next_gid)
            fresh = lane < n_refill
            gid2 = torch.where(fresh, self.next_gid + lane,
                               torch.where(lane < n_not_alive, total, gid))
            new_f, new_i = self._fresh(torch.clamp(gid2, max=total - 1))
            torch.where(fresh, new_f, ray_f, out=self.ray_f)
            torch.where(fresh, new_i, ray_i, out=self.ray_i)
            self.gid.copy_(gid2)
            self.dep.copy_(dep.masked_fill(fresh, 0))
            self.next_gid.add_(n_refill)
            self.iterations.add_(1)

    def radiance(self) -> torch.Tensor:
        """The window's radiance summed over its samples, (n_pix, 3) f32:
        gid = sample · n_pix + pixel, so the sample axis is summed."""
        return self.acc[:self.total].reshape(self.spp, self.cfg.n_pixels, 3).sum(dim=0)


def program(mega, cfg: CameraConfig, seed: int, *, fused: bool, **kw) -> graphs.WhileProgram:
    """A :class:`Pool` (``kw``: its options) and the WhileProgram that
    drives its loop, the pool as the program's ``state``."""
    pool = Pool(mega, cfg, seed, **kw)
    return graphs.WhileProgram(pool.step, pool.flag, pool.device, pool, fused=fused)


def trace_pool(mega, cfg: CameraConfig, params: CameraParams, seed: int, *,
               pool_size: int = POOL_SIZE, sample_start: int = 0, n_samples=None,
               motion_blur: bool = True, cull=None, fused: bool = False):
    """Trace ``cfg.n_pixels × n_samples`` paths (samples ``sample_start``
    on) through a new pool. Returns ``(radiance summed over the samples
    (n_pix, 3) f32, segments)``, ``segments`` an int64 0-d tensor, both on
    the scene's device. ``fused``: the loop as a captured WHILE graph on a
    card (a capture each call); else the host loop."""
    prog = program(mega, cfg, seed, fused=fused, pool_size=pool_size, n_samples=n_samples,
                   motion_blur=motion_blur, cull=cull)
    pool = prog.state
    prog.run(lambda: pool.init(params, sample_start))
    return pool.radiance(), pool.segments
