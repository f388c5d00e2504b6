"""Profiling hooks, the counterpart of ``raytracing_tpu.utils.profiling``:
``torch.profiler`` traces, the port's named host spans and device stage
clock, and the per-bounce wavefront occupancy.

One switch, off by default (:func:`enable`, :func:`enabled`;
:func:`trace_to` turns it on for its block), turns on two kinds of
tracing:

* **Host spans** (:func:`annotate`): ``record_function`` ranges named
  ``rt.*`` (a render, its replays and its finish, a sweep, a plan, a
  program's capture and init, the copy to the host), which land in the
  same ``torch.profiler`` timeline as the device's kernels, so an idle
  stretch of the device can be named by the span open over it
  (:func:`idle_by_span`). None opens per replay.
* **The stage clock** (:func:`stage`): the device time of each named
  stage of a render, sweep or pool step (:data:`STAGES`), taken on the
  device by two launches of a one-thread kernel (``csrc/stage_clock.cu``,
  ``rt_stage_mark``) that read its nanosecond clock, so it is captured
  into CUDA graphs and WHILE bodies with the step and adds up over every
  replay with no host read; :func:`stage_totals` reads the totals once.
  On the CPU a stage adds ``perf_counter`` seconds instead.

With the switch off both launch and record nothing. A program captured
with the switch off holds no mark and one captured with it on holds its
marks, so the switch is part of every program's key
(``render/graphs.py`` ``ProgramSlot``): neither is replayed under the
other setting.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from .. import _kernels

TRACE_FILE = "trace.json"
SPAN_PREFIX = "rt."
NO_SPAN = "no rt. span"  # idle time with no span of the port open over it
# The stages of a step, which partition it (stages do not nest):
#   camera      camera rays (ray generation, K1's ray packing, the replay's
#               regenerated rays, the pool's refill) and a trace's start state;
#   k1          each K1 (or K5) launch with its launch count;
#   compact     between phases: segments, counts and ids, the alive-first
#               sort and its gathers, the next phase's prefix check and inputs;
#               the pool's partition sort;
#   accumulate  radiance into the image and the step's sums;
#   loss        a sweep chunk's image, loss and radiance cotangent;
#   sort        the replay's length sort, its gathers and packed rays;
#   k2          K2; fold: the table reduction of K2's cotangents;
#   vjp         the replay table's build and its backward (autograd);
#   bank        the pool's dead rays written to their rows.
STAGES = ("camera", "k1", "compact", "accumulate", "loss", "sort", "k2", "fold", "vjp",
          "bank")
_INDEX = {name: k for k, name in enumerate(STAGES)}
_NULL = contextlib.nullcontext()


class _Clock:
    """The switch and the stage totals: per CUDA device a ``(3,
    len(STAGES))`` int64 buffer (begin ns, total ns, calls) that the
    marks write, allocated outside capture as ``_kernels.LaunchCount``
    allocates its counters; for the CPU, host seconds and calls."""

    def __init__(self):
        self.on = False
        self.open: Optional[str] = None  # the stage open now
        self.buffers: dict[torch.device, torch.Tensor] = {}
        self.host: dict[str, list] = {}

    def buffer(self, dev: torch.device) -> torch.Tensor:
        buf = self.buffers.get(dev)
        if buf is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a stage's first mark on a device is under CUDA graph "
                                   "capture: run the step once eagerly (a warm-up) first")
            buf = self.buffers[dev] = torch.zeros((3, len(STAGES)), dtype=torch.int64,
                                                  device=dev)
        return buf


_clock = _Clock()


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def enable(on: bool = True) -> None:
    """Turn the port's spans and stage clock on or off (off at import)."""
    _clock.on = bool(on)


def enabled() -> bool:
    return _clock.on


@contextlib.contextmanager
def trace_to(logdir: Optional[str]) -> Iterator[None]:
    """Profile the host and, where there is one, the card, with the switch
    on (spans and stages), and write a Chrome trace (chrome://tracing,
    Perfetto) to ``logdir/trace.json``. No-op when logdir is None."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = _clock.on
    _clock.on = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
    finally:
        _clock.on = was
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """Named trace span for host-side phases (``rt.*`` in the port): a
    ``record_function`` with the switch on, else a no-op."""
    return torch.profiler.record_function(name) if _clock.on else _NULL


class _Stage:
    def __init__(self, name: str, dev: torch.device):
        self.name, self.index, self.dev = name, _INDEX[name], dev

    def _mark(self, end: int) -> None:
        lib = _kernels.library().lib
        with torch.cuda.device(self.dev):
            err = lib.rt_stage_mark_launch(self.buf.data_ptr(), len(STAGES), self.index, end,
                                           torch.cuda.current_stream(self.dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"stage mark launch failed: {lib.rt_error_string(err).decode()}")

    def __enter__(self):
        if _clock.open is not None:
            raise RuntimeError(f"stage {self.name!r} opened inside stage {_clock.open!r}: "
                               "stages do not nest")
        _clock.open = self.name
        if self.dev.type == "cuda":
            self.buf = _clock.buffer(self.dev)
            self._mark(0)
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        _clock.open = None
        if exc_type is None:
            if self.dev.type == "cuda":
                self._mark(1)
            else:
                row = _clock.host.setdefault(self.name, [0.0, 0])
                row[0] += time.perf_counter() - self.t0
                row[1] += 1
        return False


def stage(name: str, device):
    """The work launched in this block as one call of stage ``name`` (one of
    :data:`STAGES`) on ``device``: with the switch on, a begin and an end
    mark on the device's current stream (captured with the block into a
    graph), or host seconds on the CPU; with it off, nothing. Opening a
    stage inside another raises."""
    if not _clock.on:
        return _NULL
    if name not in _INDEX:
        raise ValueError(f"unknown stage {name!r}; the stages are {STAGES}")
    return _Stage(name, _device(device))


def stage_totals(device) -> dict:
    """The stage clock on ``device`` since the last :func:`reset_stages`,
    read with one host copy: ``{"device": the device's name, "clock":
    "globaltimer" (device time, on a CUDA device) or "perf_counter" (host
    time, on the CPU), "stages": {stage: (seconds, calls)}}`` of every
    stage with a call."""
    dev = _device(device)
    if dev.type != "cuda":
        return dict(device=str(dev), clock="perf_counter",
                    stages={n: (s, c) for n, (s, c) in _clock.host.items() if c})
    stages = {}
    buf = _clock.buffers.get(dev)
    if buf is not None:
        total, calls = buf[1:].cpu().tolist()
        stages = {n: (t * 1e-9, c) for n, t, c in zip(STAGES, total, calls) if c}
    return dict(device=torch.cuda.get_device_name(dev), clock="globaltimer", stages=stages)


def reset_stages() -> None:
    """Zero every stage total in place, so programs captured before go on
    adding to the same buffers."""
    for buf in _clock.buffers.values():
        buf.zero_()
    _clock.host.clear()


def idle_by_span(device: list, host: list, lo: float, hi: float) -> dict:
    """``{span: seconds}``: every stretch of ``[lo, hi]`` with nothing on
    the device, summed by the innermost ``rt.`` span open over it (the
    latest to start), stretches split at span edges; time under no such
    span goes to :data:`NO_SPAN`. ``device`` holds ``(start, end)`` of
    every device operation and ``host`` ``(name, start, end)`` of host
    ranges, in a ``torch.profiler`` trace's microseconds."""
    busy = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in device):
        if e <= s:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    spans = [(s, e, n) for n, s, e in host if n.startswith(SPAN_PREFIX) and e > lo and s < hi]
    out: dict[str, float] = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        cuts = sorted({a, b, *(x for s, e, _ in spans for x in (s, e) if a < x < b)})
        for x, y in zip(cuts, cuts[1:]):
            mid = 0.5 * (x + y)
            open_ = [(s, -e, n) for s, e, n in spans if s <= mid <= e]
            name = max(open_)[2] if open_ else NO_SPAN
            out[name] = out.get(name, 0.0) + (y - x) * 1e-6
    return out


def occupancy_histogram(scene, cfg, seed: int = 0, batch: int = 1 << 14) -> torch.Tensor:
    """Per-bounce active-ray occupancy, the wavefront analog of a path-depth
    histogram: a (max_depth,) CPU tensor of live fractions, from one sample
    of the first ``batch`` pixels through the integrator's bounce with the
    brute-force closest hit, on the scene's device."""
    from ..ops.intersect import closest_hit_brute
    from ..render import camera as cam_mod
    from ..render.camera import CameraParams
    from ..render.integrator import _bounce_once, initial_state

    dev = scene.spheres.center.device
    derived = cam_mod.derive(cfg, CameraParams.from_config(cfg, dev))
    n = min(batch, cfg.n_pixels)
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    samp = torch.zeros(n, dtype=torch.int32, device=dev)
    o, d, t = cam_mod.generate_rays(cfg, derived, pix, samp, seed,
                                    motion_blur=scene.flags.has_moving)
    background = torch.tensor(cfg.background, dtype=torch.float32, device=dev)
    state = initial_state(o, d, t, pix, samp)
    fracs = []
    with torch.no_grad():
        for bounce in range(cfg.max_depth):
            fracs.append(float(state[7].float().mean()))
            state = _bounce_once(scene, background, seed, closest_hit_brute, state, bounce)
    return torch.tensor(fracs)
