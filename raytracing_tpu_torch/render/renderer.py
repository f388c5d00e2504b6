"""Top-level renderer, the counterpart of ``raytracing_tpu.render.renderer``.

``hit_method`` picks how a launch traces its rays:

* ``"mega"``: the megakernels (K1, or K5 on large scenes) through one of
  the two schedules below; it raises on a scene the kernels' tables cannot
  express (bilinear image filtering, checkers of non-solid textures);
* ``"brute"``: the wavefront integrator (``render/integrator.py``) with
  the brute-force closest hit, at the JAX ``Renderer``'s defaults
  (``mode="scan"``, no remat: the forward render records no autograd);
  it renders every scene, phased launches only;
* ``"bvh"``: the same integrator with the closest hit of the scene's BVH
  (``ops/traverse.py``: on the card one ``rt_bvh_walk`` launch a bounce);
  it raises on a scene compiled without one;
* ``"auto"`` (the default): ``"mega"`` when the scene can be expressed in
  the kernels' tables, else ``"bvh"`` when the scene has a BVH and more
  than 64 primitives, else ``"brute"``, decided from the scene alone.

The megakernel schedules:

* ``schedule="phased"``: launches of (pixel block × sample chunk) rays
  through the phased megakernel trace, accumulated into the image. The
  integrator's methods render in these launches too. With ``fused=True``
  (the default, as in the JAX package) one launch's ops are captured once
  as a CUDA graph (``render/graphs.py``), keyed on (scene, seed, device),
  and replayed once a launch, the launch's offsets read from a device
  counter; the image, segments and ``ok`` cross to the host in one copy
  at the end; the integrator's methods (``"brute"``, ``"bvh"``) replay
  theirs the same way. ``fused=False``, ``progress`` and
  ``checkpoint_cb`` take the launch loop instead: a Python loop that never
  waits on the device until the image is copied to the host at the end,
  unless ``checkpoint_cb`` asks for the state after every sample chunk.
  ``render(resume_state=)`` picks a render up from such a state, bit for
  bit, fused or not.
* ``schedule="pool"``: the regenerating pool (``render/pool.py``), one
  persistent wavefront for the whole render, split into sample windows
  only where the (pixel, sample) stream passes ``MAX_POOL_STREAM``. With
  ``fused=True`` (the default) each window is one launch of a CUDA graph
  whose device-side WHILE node runs a captured pool iteration until the
  window is done, captured once per (scene, seed, window size), as the JAX
  package runs each window as one compiled ``while_loop``; nothing is read
  from the device until the image is copied to the host. ``fused=False``
  runs the iterations from a host loop that reads the loop's flag once an
  iteration. It has no sample chunks to checkpoint, and refuses
  ``resume_state`` and ``checkpoint_cb``.
"""
from __future__ import annotations

import math
import time as _time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..core.color import to_u8_image
from ..ops.intersect import closest_hit_brute
from ..ops.traverse import closest_hit_bvh
from ..ops.megakernel import build_mega_scene, expressible, select_layout, trace_megakernel
from ..scene.types import Scene
from ..utils.profiling import annotate, stage
from . import camera as cam_mod
from . import graphs
from . import integrator
from . import pool as pool_mod
from .camera import CameraConfig, CameraParams

HIT_METHODS = ("auto", "mega", "brute", "bvh")
INTEGRATOR_HIT_FNS = {"brute": closest_hit_brute, "bvh": closest_hit_bvh}
BVH_MIN_PRIMS = 64  # "auto" takes the BVH above this many primitives
MAX_RAYS_PER_LAUNCH = 1 << 18  # the Renderer's default launch size


@dataclass
class RenderResult:
    radiance: Optional[np.ndarray]  # (H, W, 3) f32 mean radiance (None with transfer="u8")
    segments: int                   # ray-scene queries traced
    seconds: float                  # wall time of the launches and the copy to the host
    launches: int
    u8: Optional[np.ndarray] = None  # (H, W, 3) u8, quantized on the device
    ok: Optional[bool] = None        # phase-prefix validity (None: no prefixes)

    @property
    def image_u8(self) -> np.ndarray:
        if self.u8 is not None:
            return self.u8
        return to_u8_image(torch.from_numpy(self.radiance)).numpy()


def _default_phases(cfg: CameraConfig, phase_depths):
    if phase_depths is None and cfg.max_depth > 6:
        return [2, 3, cfg.max_depth - 5]
    return phase_depths


def launch_shape(cfg: CameraConfig, max_rays_per_launch: int = MAX_RAYS_PER_LAUNCH):
    """``(n_block, spp_chunk)`` of a launch: n_block pixels (a
    1024-multiple; padding rays start dead) × spp_chunk samples, at most
    ``max_rays_per_launch`` rays unless one 1024-padded block of pixels
    alone exceeds it. A pixel's samples are summed chunk by chunk, so
    renders of the same ``spp_chunk`` sum them in the same order
    (``parallel/shard.py`` relies on it)."""
    n_block = -(-min(cfg.n_pixels, max_rays_per_launch) // 1024) * 1024
    return n_block, max(1, min(cfg.samples_per_pixel, max_rays_per_launch // n_block))


def chunk_ids(cfg: CameraConfig, pixel_start, sample_start, *, n_block: int, spp_chunk: int,
              device):
    """The rays of one launch: n_block contiguous pixels × spp_chunk
    samples, laid out sample-major. Returns (pixel_ids, sample_ids, valid,
    alive): ``valid`` marks samples below spp, ``alive`` the rays that
    start alive (padded samples and the clamped duplicates of the last
    pixel start dead). The starts are ints or 0-d int64 tensors on
    ``device`` (a replayed launch), with the same ids."""
    pix_raw = pixel_start + torch.arange(n_block, device=device)
    pix = torch.clamp(pix_raw, max=cfg.n_pixels - 1)
    pixel_ids = pix.repeat(spp_chunk)
    sample_ids = sample_start + torch.arange(spp_chunk, device=device).repeat_interleave(n_block)
    valid = sample_ids < cfg.samples_per_pixel
    alive = valid & (pix_raw < cfg.n_pixels).repeat(spp_chunk)
    return pixel_ids, sample_ids, valid, alive


def chunk_rays(cfg: CameraConfig, derived, pixel_start, sample_start,
               seed: int, *, n_block: int, spp_chunk: int, has_moving: bool, device):
    """Camera rays of one launch (:func:`chunk_ids`). Returns (o, d, time,
    pixel_ids, sample_ids, valid, alive)."""
    pixel_ids, sample_ids, valid, alive = chunk_ids(cfg, pixel_start, sample_start,
                                                    n_block=n_block, spp_chunk=spp_chunk,
                                                    device=device)
    o, d, t = cam_mod.generate_rays(cfg, derived, pixel_ids, sample_ids, seed,
                                    motion_blur=has_moving)
    return o, d, t, pixel_ids, sample_ids, valid, alive


def _render_chunk(mega, cfg: CameraConfig, camera: torch.Tensor, pixel_start, sample_start,
                  seed: int, *, n_block: int, spp_chunk: int,
                  has_moving: bool, phases, phase_prefixes=None,
                  want_counts: bool = False, cull=None):
    """One launch, its rays started from ``camera`` (``camera.pack_camera``
    of the derived camera): no ray tensor is made where K1 traces the
    first phase (``trace_megakernel(camera=...)``). Returns (radiance
    summed over the chunk's samples (n_block, 3), segments, ok or None);
    with ``want_counts`` only the per-ray bounce counts. ``cull`` is K1's
    search (``trace_megakernel``). Stages (``utils.profiling``):
    ``camera`` (the ids), then the trace's own, then ``accumulate``."""
    dev = mega.sph_sweep.device
    with stage("camera", dev):
        pixel_ids, sample_ids, valid, alive = chunk_ids(
            cfg, pixel_start, sample_start, n_block=n_block, spp_chunk=spp_chunk, device=dev)
    out = trace_megakernel(mega, None, None, None, pixel_ids, sample_ids, cfg.background,
                           cfg.max_depth, seed, phase_depths=phases, active0=alive,
                           want_counts=want_counts, phase_prefixes=phase_prefixes, cull=cull,
                           camera=cam_mod.CameraStart.of(cfg, camera, has_moving))
    if want_counts:
        return out[2]
    with stage("accumulate", dev):
        radiance = torch.where(valid[:, None], out[0], 0.0)
        rad = radiance.reshape(spp_chunk, n_block, 3).sum(dim=0)
    return rad, out[1], (out[2] if phase_prefixes is not None else None)


def _integrator_chunk(scene: Scene, cfg: CameraConfig, derived, pixel_start,
                      sample_start, seed: int, *, n_block: int, spp_chunk: int,
                      hit_fn: Callable, background: torch.Tensor):
    """One launch through the wavefront integrator with the closest hit
    ``hit_fn``: (radiance summed over the chunk's samples (n_block, 3),
    segments as a 0-d int64 tensor on the device). ``background``: the
    config's as an f32 tensor on the device, so a replayed launch copies
    nothing from the host."""
    o, d, t, pixel_ids, sample_ids, valid, alive = chunk_rays(
        cfg, derived, pixel_start, sample_start, seed, n_block=n_block,
        spp_chunk=spp_chunk, has_moving=scene.flags.has_moving,
        device=scene.spheres.radius.device)
    radiance, segments = integrator.trace(
        scene, o, d, t, pixel_ids, sample_ids, background, cfg.max_depth, seed,
        hit_fn=hit_fn, mode="scan", remat=False, active0=alive)
    radiance = torch.where(valid[:, None], radiance, 0.0)
    return radiance.reshape(spp_chunk, n_block, 3).sum(dim=0), segments


def rays_past(counts: torch.Tensor, max_depth: int) -> torch.Tensor:
    """``(max_depth + 1,)`` int64: how many rays traced at least k
    bounces (per-ray ``counts``, clamped to ``max_depth``), for every k.
    No host read (``graphs.histogram``)."""
    hist = graphs.histogram(torch.clamp(counts, 0, max_depth), max_depth + 1)
    return torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])


class Renderer:
    """Renders a scene on the device its tensors live on, through the
    megakernels or the wavefront integrator (``hit_method``, see the
    module note). The phased megakernel trace picks its layout from the
    scene (``ops.megakernel.select_layout``): K1, or K5's BVH walk above
    ``BVH_MIN_CHUNKS`` chunks of 8 primitives. The pool schedule runs K1
    (its depth cap is K1's alone) with ``pool.POOL_SIZE`` lanes, at most
    the stream's length. Schedules, phase prefixes and ``cull`` belong to
    the megakernel: the integrator renders in phased launches without
    them. ``cull`` forces K1's search in every launch (None: by the scene,
    ``ops.megakernel_block.walks``); it changes speed, never a result.

    ``fused`` (default True) renders and plans the phased schedule as one
    launch program replayed once a launch (a CUDA graph on a card; see the
    module note for what takes the loop), and each sample window of the
    pool as one launch of a WHILE program. The renderer keeps one program,
    the last (kind, scene, seed, device) it ran, and its graph's memory;
    :attr:`programs` holds it, with its ``capture_seconds`` (a pool render
    split into windows of two sizes keeps its shorter window's program in
    a second slot)."""

    def __init__(self, cfg: CameraConfig, *, hit_method: str = "auto",
                 max_rays_per_launch: int = MAX_RAYS_PER_LAUNCH, phase_depths=None,
                 transfer: str = "f32", phase_prefixes=None, strict_prefixes: bool = True,
                 schedule: str = "phased", cull=None, fused: bool = True):
        if hit_method not in HIT_METHODS:
            raise ValueError(f"hit_method must be one of {HIT_METHODS}, got {hit_method!r}")
        if transfer not in ("f32", "u8"):
            raise ValueError(f"transfer must be 'f32' or 'u8', got {transfer!r}")
        if schedule not in ("phased", "pool"):
            raise ValueError(f"schedule must be 'phased' or 'pool', got {schedule!r}")
        self.hit_method = hit_method
        self.cull = cull
        self.cfg = cfg
        self.transfer = transfer
        self.schedule = schedule
        self.phase_depths = _default_phases(cfg, phase_depths)
        self.phase_prefixes = tuple(phase_prefixes) if phase_prefixes is not None else None
        if hit_method in INTEGRATOR_HIT_FNS:
            self._refuse_integrator(hit_method)
        self.strict_prefixes = strict_prefixes
        self.n_block, self.spp_chunk = launch_shape(cfg, max_rays_per_launch)
        self.fused = fused
        self.programs = graphs.ProgramSlot()
        self._tail_programs = graphs.ProgramSlot()  # the pool's shorter last window
        self._mega = None
        self._mega_scene = None
        self._cameras = {}  # device → (CameraParams, background), made once a device

    def _refuse_integrator(self, method: str):
        """The integrator has no pool schedule and no phase prefixes."""
        what = ("schedule='pool'" if self.schedule == "pool"
                else "phase_prefixes" if self.phase_prefixes is not None
                else "cull" if self.cull is not None else None)
        if what is not None:
            raise ValueError(f"{what} belongs to the megakernel (hit_method='mega'); this "
                             f"renderer traces through the integrator (hit_method='{method}')")

    def _camera(self, dev):
        """The config's ``CameraParams`` and its background as an f32
        tensor on ``dev``, copied from the host once a device, so that a
        later render reads and copies nothing from the host until its
        image comes back."""
        dev = torch.device(dev)
        if dev not in self._cameras:
            self._cameras[dev] = (CameraParams.from_config(self.cfg, dev), torch.tensor(
                self.cfg.background, dtype=torch.float32, device=dev))
        return self._cameras[dev]

    def resolve_hit_method(self, scene: Scene) -> str:
        """``"mega"``, ``"bvh"`` or ``"brute"``: how :meth:`render` traces
        ``scene``. ``"auto"`` takes the megakernel exactly when the scene
        can be expressed in its tables (``ops.megakernel.expressible``),
        else the BVH when the scene has one over more than
        :data:`BVH_MIN_PRIMS` primitives, as the JAX ``Renderer`` does off
        the CPU."""
        if self.hit_method == "auto":
            if expressible(scene):
                return "mega"
            if scene.bvh is not None and scene.n_primitives > BVH_MIN_PRIMS:
                return "bvh"
            return "brute"
        return self.hit_method

    def _get_mega(self, scene: Scene):
        if self._mega is None or scene is not self._mega_scene:
            self._mega = build_mega_scene(scene)
            self._mega_scene = scene
        return self._mega

    def _grid(self):
        """(n_blocks, n_schunks): launch ``c`` (in render order) traces
        block ``c % n_blocks`` of sample chunk ``c // n_blocks``."""
        return (-(-self.cfg.n_pixels // self.n_block),
                -(-self.cfg.samples_per_pixel // self.spp_chunk))

    def _launch_starts(self, c):
        """(pixel_start, sample_start, block) of launch ``c`` in render
        order: ints for an int ``c``, 0-d int64 tensors for a replay's
        device counter (the same integers)."""
        n_blocks, _ = self._grid()
        b = c % n_blocks
        return b * self.n_block, (c // n_blocks) * self.spp_chunk, b

    def _program_key(self, kind: str, scene: Scene, seed: int, dev):
        """What a launch program of ``kind`` is captured for. Its step
        holds the scene, so the scene's id names no other while it lives."""
        return (kind, id(scene), int(seed), str(dev), self.phase_prefixes, self.cull)

    def _chunk_kwargs(self, scene: Scene):
        return dict(n_block=self.n_block, spp_chunk=self.spp_chunk,
                    has_moving=scene.flags.has_moving, phases=self.phase_depths)

    def plan_phase_prefixes(self, scene: Scene, seed: int = 0, margin_blocks: int = 1):
        """Untimed planning pass: trace every launch's ray stream for its
        per-ray bounce counts and return the per-phase live-ray prefixes
        for ``Renderer(..., phase_prefixes=...)`` on the same scene, config,
        batching and seed, with ``margin_blocks`` blocks of slack. None for
        a single-phase schedule. Raises ValueError on a scene that traces
        through the integrator or the group layout (K5), neither of which
        counts per-ray bounces."""
        method = self.resolve_hit_method(scene)
        if method != "mega":
            raise ValueError("phase prefixes belong to the megakernel (hit_method='mega'); "
                             f"this scene renders through the integrator (hit_method='{method}')")
        mega = self._get_mega(scene)
        cfg = self.cfg
        phases = self.phase_depths
        if phases is None or len(phases) < 2:
            return None
        if select_layout(mega)[0] != "block":
            raise ValueError(
                f"phase prefixes need the block layout's per-ray bounce counts; this scene "
                f"({mega.n_prims} primitive columns) renders through the group layout (K5), "
                f"which takes no prefixes: render it without phase_prefixes")
        dev = mega.sph_sweep.device
        d = cfg.max_depth
        kw = dict(self._chunk_kwargs(scene), want_counts=True)

        def make_state():
            derived = cam_mod.derive(cfg, CameraParams.from_config(cfg, dev))
            return dict(camera=cam_mod.pack_camera(derived),
                        nb_max=torch.zeros(d + 1, dtype=torch.int64, device=dev))

        def step(c, st):
            pixel_start, sample_start, _ = self._launch_starts(c)
            cnt = _render_chunk(mega, cfg, st["camera"], pixel_start, sample_start, seed, **kw)
            with stage("accumulate", dev):
                torch.maximum(st["nb_max"], rays_past(cnt, d), out=st["nb_max"])

        st, _ = graphs.over_chunks(self.programs, self._program_key("plan", scene, seed, dev),
                                   make_state, step, 0, math.prod(self._grid()), dev,
                                   self.fused)
        nb_max = st["nb_max"]
        nb_max = nb_max.cpu().numpy()
        B = self.n_block * self.spp_chunk
        out = [None]
        start = 0
        for pdep in phases[:-1]:
            start += pdep
            live = int(nb_max[min(start + 1, d)])
            out.append(max(1024, min(B, (-(-live // 1024) + margin_blocks) * 1024)))
        return tuple(out)

    def _checked(self, result: RenderResult) -> RenderResult:
        """An undersized prefix (ok=False) dropped live paths: raise unless
        the caller opted into inspecting it with ``strict_prefixes=False``."""
        if self.strict_prefixes and result.ok is False:
            raise RuntimeError(
                "phase_prefixes exceeded: a phase's static live prefix was smaller "
                "than its live ray set, so the render dropped paths "
                "(RenderResult.ok=False). Re-plan with larger prefixes, or pass "
                "strict_prefixes=False to inspect the flagged result.")
        return result

    def _render_pool(self, scene: Scene, mega, params: CameraParams,
                     seed: int) -> RenderResult:
        """The regenerating-pool schedule: one pool per sample window, the
        windows' radiance summed on the device and copied to the host once.
        ``transfer="u8"`` quantizes on the device when the render is one
        window; a split render returns its f32 radiance, as in the JAX
        package. With ``fused`` each window is one launch of its size's
        WHILE program (``render/pool.py``), kept in :attr:`programs` (the
        full windows) and a second slot (a shorter last window), keyed on
        (scene, seed, device, window samples, pool size, ``cull``), as the
        JAX package compiles one executable per window size; ``seconds``
        leaves out their capture."""
        cfg = self.cfg
        spp = cfg.samples_per_pixel
        spp_w = min(spp, max(1, (pool_mod.MAX_POOL_STREAM - 1) // cfg.n_pixels))
        windows = [(s, min(spp_w, spp - s)) for s in range(0, spp, spp_w)]
        u8_mode = self.transfer == "u8" and len(windows) == 1
        dev = mega.sph_sweep.device
        t0 = _time.perf_counter()
        capture_s = 0.0
        acc = seg = banked = None
        with annotate("rt.render.replay"):
            for start, n in windows:
                kw = dict(pool_size=min(pool_mod.POOL_SIZE, -(-cfg.n_pixels * n // 1024) * 1024),
                          n_samples=n, motion_blur=scene.flags.has_moving, cull=self.cull)
                if self.fused:
                    slot = self.programs if n == spp_w else self._tail_programs
                    key = ("pool", id(scene), int(seed), str(dev), n, kw["pool_size"], self.cull)
                    prog = slot.get(key, lambda: pool_mod.program(mega, cfg, seed, fused=True,
                                                                  **kw))
                else:
                    prog = pool_mod.program(mega, cfg, seed, fused=False, **kw)
                pool = prog.state
                capture_s += prog.run(lambda: pool.init(params, start))
                # new tensors: the next window of this size rewrites the pool's
                rad = pool.radiance()
                acc = rad if acc is None else acc + rad
                seg = pool.segments.clone() if seg is None else seg + pool.segments
                banked = pool.banked.clone() if banked is None else banked + pool.banked
        with annotate("rt.render.finish"):
            mean = (acc / spp).reshape(cfg.image_height, cfg.image_width, 3)
            img_h, seg_h, banked_h = graphs.to_host(to_u8_image(mean) if u8_mode else mean,
                                                    seg, banked)
        seconds = _time.perf_counter() - t0 - capture_s
        if int(banked_h) != cfg.n_pixels * spp:
            raise RuntimeError(f"pool banked {int(banked_h)} paths of {cfg.n_pixels * spp}")
        if u8_mode:
            return RenderResult(None, int(seg_h), seconds, len(windows), u8=img_h)
        return RenderResult(img_h, int(seg_h), seconds, len(windows))

    def render(self, scene: Scene, params: Optional[CameraParams] = None, seed: int = 0,
               progress: bool = False, resume_state: Optional[dict] = None,
               checkpoint_cb: Optional[Callable[[dict], None]] = None) -> RenderResult:
        """Render ``scene``. ``progress`` prints the sample chunks left after
        each one. ``checkpoint_cb`` receives, after every sample chunk, the
        render state ``{"accum": (n_blocks · n_block, 3) f32 host copy of
        the per-pixel radiance sums, "segments": int, "schunk": the next
        sample chunk}``; ``resume_state`` (such a state, e.g. from
        ``utils.checkpoint.load_render_state``) starts the launches at its
        sample chunk, and the render then equals the whole one bit for bit.
        The state belongs to this renderer's launch shape: an ``accum`` of
        another shape raises. The pool schedule has no sample chunks: it
        refuses both and prints no progress.

        With ``fused`` the phased launches replay one launch program,
        whichever hit method traces them, unless ``progress`` or
        ``checkpoint_cb`` is given, which take the launch loop (as the JAX
        ``Renderer`` keeps its loop for progress and checkpoints), and the
        pool runs each sample window as one launch of a WHILE program. The
        result is the loop's, bit for bit; ``seconds`` leaves out the
        programs' one-time capture. With the port's tracing switch on
        (``utils.profiling``) the render is the span ``rt.render``, its
        launches ``rt.render.replay`` and its copy ``rt.render.finish``."""
        with annotate("rt.render"):
            return self._render(scene, params, seed, progress, resume_state, checkpoint_cb)

    def _render(self, scene: Scene, params, seed, progress, resume_state, checkpoint_cb):
        cfg = self.cfg
        method = self.resolve_hit_method(scene)
        if method in INTEGRATOR_HIT_FNS:
            self._refuse_integrator(method)
            if method == "bvh" and scene.bvh is None:
                raise ValueError("scene was compiled without a BVH (hit_method='bvh' needs "
                                 "SceneBuilder.compile(use_bvh=True))")
            mega, dev = None, scene.spheres.radius.device
        else:
            mega = self._get_mega(scene)
            dev = mega.sph_sweep.device
        if params is None:
            params = self._camera(dev)[0]
        if dev.type == "cuda" and method != "brute":
            from .. import _kernels

            _kernels.library()  # build outside the timed region
        if self.schedule == "pool":
            if resume_state is not None or checkpoint_cb is not None:
                raise ValueError("schedule='pool' has no sample chunks to checkpoint or resume "
                                 "from; render with schedule='phased'")
            return self._render_pool(scene, mega, params, seed)
        n_blocks, n_schunks = self._grid()
        acc_h, start, seg_base = self._resumed(resume_state)
        n_block, spp_chunk = self.n_block, self.spp_chunk
        hit_fn = INTEGRATOR_HIT_FNS.get(method)

        def make_state():
            if acc_h is None:
                accum = torch.zeros((n_blocks * n_block, 3), dtype=torch.float32, device=dev)
            else:
                accum = torch.from_numpy(acc_h.copy()).to(dev)
            derived = cam_mod.derive(cfg, params)
            # the integrator generates its rays; the megakernel's K1 computes them
            camera = (dict(derived=derived) if hit_fn is not None
                      else dict(camera=cam_mod.pack_camera(derived)))
            return dict(**camera, accum=accum,
                        segments=torch.zeros((), dtype=torch.int64, device=dev),
                        ok=torch.ones((), dtype=torch.bool, device=dev),
                        background=self._camera(dev)[1])

        def step(c, st):
            """Launch ``c``: its radiance added into its block of ``accum``
            (one addend an element, so an int's slice and a replay's device
            index give the same bits), its segments and ``ok`` into theirs."""
            pixel_start, sample_start, b = self._launch_starts(c)
            ok_c = None
            if hit_fn is not None:
                with torch.no_grad():
                    rad, seg = _integrator_chunk(
                        scene, cfg, st["derived"], pixel_start, sample_start, seed,
                        n_block=n_block, spp_chunk=spp_chunk, hit_fn=hit_fn,
                        background=st["background"])
            else:
                rad, seg, ok_c = _render_chunk(
                    mega, cfg, st["camera"], pixel_start, sample_start, seed,
                    **self._chunk_kwargs(scene), phase_prefixes=self.phase_prefixes,
                    cull=self.cull)
            with stage("accumulate", dev):
                if ok_c is not None:
                    st["ok"].logical_and_(ok_c)
                acc3 = st["accum"].view(n_blocks, n_block, 3)
                if isinstance(b, torch.Tensor):
                    b = b.reshape(1)
                    acc3.index_copy_(0, b, acc3.index_select(0, b) + rad[None])
                else:
                    acc3[b] += rad
                st["segments"].add_(seg)

        t0 = _time.perf_counter()
        first, total = start * n_blocks, (n_schunks - start) * n_blocks
        with annotate("rt.render.replay"):
            if self.fused and checkpoint_cb is None and not progress:
                st, capture_s = graphs.over_chunks(
                    self.programs, self._program_key("render", scene, seed, dev), make_state,
                    step, first, total, dev, True)
            else:
                st, capture_s = make_state(), 0.0
                for s in range(start, n_schunks):
                    for c in range(s * n_blocks, (s + 1) * n_blocks):
                        step(c, st)
                    if progress:
                        print(f"\rsample chunks remaining: {n_schunks - s - 1} ", end="",
                              flush=True)
                    if checkpoint_cb is not None:
                        checkpoint_cb({"accum": st["accum"].to("cpu", copy=True).numpy(),
                                       "segments": seg_base + int(st["segments"]),
                                       "schunk": s + 1})
        with annotate("rt.render.finish"):
            mean = (st["accum"][:cfg.n_pixels] / cfg.samples_per_pixel).reshape(
                cfg.image_height, cfg.image_width, 3)
            img = to_u8_image(mean) if self.transfer == "u8" else mean
            img_h, seg_h, ok_h = graphs.to_host(img, st["segments"], st["ok"])
        seconds = _time.perf_counter() - t0 - capture_s
        if progress:
            print("\rDone.                        ", flush=True)
        return self._result(img_h, seg_base + int(seg_h), seconds, total,
                            bool(ok_h) if self.phase_prefixes is not None else None)

    def _resumed(self, resume_state: Optional[dict]):
        """``(accum host array or None, first sample chunk, segments so
        far)`` of a render started from ``resume_state`` (or from
        scratch)."""
        if resume_state is None:
            return None, 0, 0
        n_blocks, n_schunks = self._grid()
        acc_h = np.asarray(resume_state["accum"], np.float32)
        if acc_h.shape != (n_blocks * self.n_block, 3):
            raise ValueError(
                f"resume_state['accum'] has shape {acc_h.shape}, but this renderer's "
                f"launches accumulate into ({n_blocks * self.n_block}, 3) "
                f"({n_blocks} blocks of {self.n_block} pixels): resume with the "
                f"max_rays_per_launch the state was saved with")
        start = int(resume_state["schunk"])
        if not 0 <= start <= n_schunks:
            raise ValueError(f"resume_state['schunk'] = {start} is outside this render's "
                             f"{n_schunks} sample chunks")
        return acc_h, start, int(resume_state["segments"])

    def _result(self, img_h, segments: int, seconds: float, launches: int, ok_h):
        if self.transfer == "u8":
            return self._checked(RenderResult(None, segments, seconds, launches, u8=img_h,
                                              ok=ok_h))
        return self._checked(RenderResult(img_h, segments, seconds, launches, ok=ok_h))


def render(scene: Scene, cfg: CameraConfig, params: Optional[CameraParams] = None,
           seed: int = 0, hit_method: str = "auto", max_rays_per_launch: int = 1 << 20,
           progress: bool = False) -> RenderResult:
    """One-shot functional API over :class:`Renderer`."""
    return Renderer(cfg, hit_method=hit_method,
                    max_rays_per_launch=max_rays_per_launch).render(scene, params, seed,
                                                                    progress=progress)
