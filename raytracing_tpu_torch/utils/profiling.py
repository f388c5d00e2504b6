"""Profiling hooks, the counterpart of ``raytracing_tpu.utils.profiling``:
``torch.profiler`` traces around render stages, named spans, and the
per-bounce wavefront occupancy."""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_to(logdir: Optional[str]) -> Iterator[None]:
    """Profile the host and, where there is one, the card, and write a
    Chrome trace (chrome://tracing, Perfetto) to ``logdir/trace.json``.
    No-op when logdir is None."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """Named trace span for host-side phases."""
    return torch.profiler.record_function(name)


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
