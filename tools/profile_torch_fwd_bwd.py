"""Where the time of the port's gradient paths goes, on one CUDA device.

    python3 tools/profile_torch_fwd_bwd.py [--path bench|fast|render_once]

``bench`` (the default) builds the fwd+bwd bench
(raytracing_tpu_torch.bench._fwd_bwd_setup: bouncing_spheres 400x225,
100 spp, depth 20, seed 7, 25 chunks of 360,448 rays, K1 decisions and
K2), plans it, then: five timed sweeps (host clock through
torch.cuda.synchronize), one sweep under torch.profiler (device time by
kernel, device busy share), and CUDA-event timings of one whole chunk.

``fast`` runs the same 25 chunks through ``replay_trace_fast`` (K1
decisions, one K4 lookup per bounce, autograd to sphere centers, texture
rgbs and the camera's lookfrom, MSE against a fixed random target): three
timed sweeps, then one chunk and one sweep under torch.profiler.

``render_once`` times ``diff.gradients.render_once`` forward+backward on
bouncing_spheres 400x225, spp 1, depth 20, with the sphere roots taken
through ``ops.intersect.sqrt_rn`` (float32 ``torch.sqrt`` on the card,
correctly rounded there) and through a float64 sqrt rounded to float32
(what ``sqrt_rn`` took on every device before), in the order A B B A.

``--search sweep`` or ``walk`` makes every K1 launch of the bench and
fast paths take that search (``cull``); the default picks it by the
scene's primitive count. ``--loop`` plans and sweeps the bench path
through its chunk loop (``fused=False``) instead of the default fused
program, a CUDA graph replayed once a chunk.

Each profile prints the device time and share of K1-K4, the table fold
and ``index_add_``. Prints the card's name, power limit and max SM clock
first.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from raytracing_tpu_torch import _kernels  # noqa: E402
from raytracing_tpu_torch import bench  # noqa: E402
from raytracing_tpu_torch.diff import gradients  # noqa: E402
from raytracing_tpu_torch.diff.replay_fast import replay_trace_fast  # noqa: E402
from raytracing_tpu_torch.models.scenes import build  # noqa: E402
from raytracing_tpu_torch.ops import intersect  # noqa: E402
from raytracing_tpu_torch.ops.megakernel import BLOCK, build_mega_scene, trace_megakernel  # noqa: E402
from raytracing_tpu_torch.render import camera as cam  # noqa: E402

from profile_torch_render import event_ms  # noqa: E402

SEED = 7
# kernel groups whose device time and share each profile prints (the
# substrings of their kernels' names in torch.profiler)
GROUPS = {"K1": ("k1_trace_block",), "K2": ("k2_replay_bwd",), "K3": ("k3_replay_fwd",),
          "K4": ("k4_table_gather",), "fold": ("k4_table_fold",),
          "index_add_": ("indexFuncLargeIndex", "indexFuncSmallIndex", "index_add")}


def timed(fn):
    """(host seconds through torch.cuda.synchronize, fn's result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def print_profile(label, fn):
    """Run ``fn`` once under torch.profiler: device time by kernel and the
    device's busy share of the host wall time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = timed(fn)
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    device_ms = sum(x[0] for x in rows) / 1e3
    print(f"profiled {label}: wall {wall * 1e3:.2f} ms, device {device_ms:.2f} ms, "
          f"busy share {device_ms / (wall * 1e3):.3f}, kernels launched {sum(x[2] for x in rows)}")
    for group, keys in GROUPS.items():
        sel = [x for x in rows if any(k in x[1] for k in keys)]
        ms = sum(x[0] for x in sel) / 1e3
        print(f"  {group}: {ms:.3f} ms in {sum(x[2] for x in sel)} launches, "
              f"{ms / max(device_ms, 1e-9):.3f} of device time")
    for dt, key, count in rows[:25]:
        print(f"  {dt / 1e3:9.3f} ms {count:6d}  {key[:100]}")


def profile_bench(cull, fused=True):
    s = bench._fwd_bwd_setup(device="cuda", cull=cull)
    print("prefixes", s["plan"](fused=fused), "decide prefixes", s["ns"]["decide_prefixes"])

    def sweep():
        return s["sweep"](fused=fused)

    sweep()
    runs = [timed(sweep) for _ in range(5)]
    print("fused" if fused else "loop", "sweep seconds", [round(t, 4) for t, _ in runs],
          "segments", int(runs[0][1][3]), "ok", [bool(o[4]) for _, o in runs])
    print_profile("sweep", sweep)
    center, rgb = s["args"]
    d_ms, h_ms = event_ms(lambda: s["grads_chunk"](center, rgb, 0), reps=10)
    print(f"whole chunk: device span {d_ms:.3f} ms, host {h_ms:.3f} ms")


def profile_fast(cull):
    dev = torch.device("cuda")
    scene, cfg = build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=100,
                       max_depth=20)
    spp_chunk, n_pix = 4, cfg.n_pixels
    npix_pad = -(-n_pix // BLOCK) * BLOCK
    pix = torch.clamp(torch.arange(npix_pad, device=dev), max=n_pix - 1).repeat(
        spp_chunk).to(torch.int32)
    act = (torch.arange(npix_pad, device=dev) < n_pix).repeat(spp_chunk)
    mega = build_mega_scene(scene)
    target = torch.from_numpy(np.random.default_rng(11).random((n_pix, 3)).astype(
        np.float32)).to(dev)
    center = scene.spheres.center.clone().requires_grad_(True)
    rgb = scene.textures.rgb.clone().requires_grad_(True)
    lookfrom = torch.tensor(cfg.lookfrom, dtype=torch.float32, device=dev, requires_grad=True)
    scene_g = dataclasses.replace(
        scene, spheres=dataclasses.replace(scene.spheres, center=center),
        textures=dataclasses.replace(scene.textures, rgb=rgb))
    params = dataclasses.replace(cam.CameraParams.from_config(cfg, dev), lookfrom=lookfrom)

    def chunk(c):
        smp = (c * spp_chunk + torch.arange(spp_chunk, device=dev).repeat_interleave(
            npix_pad)).to(torch.int32)
        o, d, t = cam.generate_rays(cfg, cam.derive(cfg, params), pix, smp, SEED,
                                    motion_blur=scene.flags.has_moving)
        with torch.no_grad():
            _, _, ids = trace_megakernel(mega, o, d, t, pix, smp, cfg.background, cfg.max_depth,
                                         SEED, phase_depths=[2, 2, 3, 4, cfg.max_depth - 11],
                                         active0=act, want_ids=True, cull=cull)
        rad, seg = replay_trace_fast(scene_g, ids, o, d, t, pix, smp, cfg.background,
                                     cfg.max_depth, SEED, remat=False, active0=act)
        img = (rad * act[:, None]).reshape(spp_chunk, npix_pad, 3).mean(0)[:n_pix]
        ((img - target) ** 2).mean().backward()
        return seg

    def sweep():
        return sum(chunk(c) for c in range(cfg.samples_per_pixel // spp_chunk))

    chunk(0)
    runs = [timed(sweep) for _ in range(3)]
    print("replay_trace_fast sweep seconds", [round(t, 4) for t, _ in runs], "segments",
          runs[0][1], "segments/s", [round(s / t) for t, s in runs])
    print_profile("replay_trace_fast chunk", lambda: chunk(1))
    print_profile("replay_trace_fast sweep", sweep)


def profile_render_once():
    dev = torch.device("cuda")
    scene, cfg = build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=1,
                       max_depth=20)
    target = torch.from_numpy(np.random.default_rng(11).random(
        (cfg.image_height, cfg.image_width, 3)).astype(np.float32)).to(dev)
    rgb = scene.textures.rgb.clone().requires_grad_(True)
    scene_g = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, rgb=rgb))
    sqrt_rn = intersect.sqrt_rn

    def fwd_bwd():
        img, seg = gradients.render_once(scene_g, cfg, seed=SEED, return_segments=True)
        ((img - target) ** 2).mean().backward()
        return seg

    def float64_route(x):
        return torch.sqrt(x.double()).float()

    for name in ("sqrt_rn", "float64", "float64", "sqrt_rn"):
        intersect.sqrt_rn = sqrt_rn if name == "sqrt_rn" else float64_route
        try:
            fwd_bwd()  # warm-up
            runs = [timed(fwd_bwd) for _ in range(3)]
        finally:
            intersect.sqrt_rn = sqrt_rn
        print(f"render_once fwd+bwd, roots through {name}: seconds "
              f"{[round(t, 4) for t, _ in runs]} segments {runs[0][1]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("bench", "fast", "render_once"), default="bench")
    ap.add_argument("--search", choices=("auto", "sweep", "walk"), default="auto")
    ap.add_argument("--loop", action="store_true", help="the bench's chunk loop (fused=False)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    _kernels.library()
    cull = {"auto": None, "sweep": False, "walk": True}[args.search]
    {"bench": lambda: profile_bench(cull, fused=not args.loop), "fast": lambda: profile_fast(cull),
     "render_once": profile_render_once}[args.path]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
