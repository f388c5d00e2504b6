"""Where the time of the port's bench render goes, on one CUDA device.

    python3 tools/profile_torch_render.py [--scene bouncing_spheres_64] [--schedule pool]

Renders the bench workload (bouncing_spheres 400x225, 100 spp, depth 20,
seed 7, schedule [2,2,3,4,9] with planned prefixes) through
raytracing_tpu_torch: five timed renders, then one render under
torch.profiler (device time by kernel, device busy share), then CUDA-event
timings of one launch's camera rays and of one whole launch. Prints the
card's name, power limit and max SM clock first. ``--scene
bouncing_spheres_64`` renders chip_smoke.py's 64x64-grid scene instead
(~4,100 spheres, traced by K5's BVH walk, which takes no prefixes);
``--scene perlin_sphere``, ``simple_light`` or ``earth`` a textured
registry scene at its registry configuration (400x225, 100 spp, depth
50, phases [2, 3, 45]). ``--schedule pool`` renders through the
regenerating pool instead (K1 only, no phases or prefixes; the two
per-launch timings are the phased schedule's and are skipped); fused, a
window runs inside a CUDA graph WHILE node whose kernels the profiler
does not see, so one window's graph launch is also timed with CUDA
events (its device span, beside the render's wall).
``--search sweep`` or ``walk`` makes every K1 launch take that search
(``Renderer(cull=)``); the default picks it by the scene's primitive
count. The profile sums K1's and K5's device time and launches.
``--loop`` renders (and plans) through the launch loop
(``Renderer(fused=False)``) instead of the default fused program, a CUDA
graph replayed once a launch.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from raytracing_tpu_torch import Renderer, _kernels, build  # noqa: E402
from raytracing_tpu_torch.render import camera as cam  # noqa: E402
from raytracing_tpu_torch.render import renderer as rmod  # noqa: E402

SEED = 7


def event_ms(fn, reps=20):
    """(device ms, host ms) per call of ``fn`` over ``reps`` calls."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e3 * (time.perf_counter() - t0) / reps


def graph_ms(fn, reps=20):
    """Device ms of ``fn`` captured as a CUDA graph, over ``reps`` replays:
    its kernels as a graph launches them (issued one by one, a call of
    some 200 small kernels is host-bound, and that many queued calls
    overflow the launch queue)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return event_ms(graph.replay, reps)[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("bouncing_spheres", "bouncing_spheres_64",
                                        "perlin_sphere", "simple_light", "earth"),
                    default="bouncing_spheres")
    ap.add_argument("--schedule", choices=("phased", "pool"), default="phased")
    ap.add_argument("--search", choices=("auto", "sweep", "walk"), default="auto")
    ap.add_argument("--loop", action="store_true", help="Renderer(fused=False)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    _kernels.library()
    if args.scene == "bouncing_spheres_64":
        from chip_smoke import bouncing_spheres_64

        scene, cfg = bouncing_spheres_64(dev)
    elif args.scene == "bouncing_spheres":
        scene, cfg = build("bouncing_spheres", device=dev, image_width=400,
                           samples_per_pixel=100, max_depth=20)
    else:
        scene, cfg = build(args.scene, device=dev)
    kw = dict(max_rays_per_launch=1 << 18, transfer="u8",
              cull={"auto": None, "sweep": False, "walk": True}[args.search],
              fused=not args.loop)
    pref = None
    if args.schedule == "pool":
        kw["schedule"] = "pool"
    elif args.scene.startswith("bouncing_spheres"):
        kw["phase_depths"] = [2, 2, 3, 4, 9]
        if args.scene == "bouncing_spheres":
            pref = Renderer(cfg, **kw).plan_phase_prefixes(scene, seed=SEED)
    r = Renderer(cfg, **kw, phase_prefixes=pref)
    for _ in range(2):
        r.render(scene, seed=SEED)
    runs = [r.render(scene, seed=SEED) for _ in range(5)]
    print(f"{args.scene} ({args.schedule}, {'loop' if args.loop else 'fused'}, K1 search "
          f"{args.search}): segments "
          f"{runs[0].segments}, render seconds", [x.seconds for x in runs])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.render(scene, seed=SEED)
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    device_ms = sum(x[0] for x in rows) / 1e3
    mk = {k: [x for x in rows if name in x[1]]
          for k, name in (("K1", "k1_trace_block"), ("K5", "k5_trace_group"))}
    print(f"profiled render: wall {wall * 1e3:.2f} ms, device {device_ms:.2f} ms, "
          f"busy share {device_ms / (wall * 1e3):.3f}, " + ", ".join(
              f"{k} {sum(x[0] for x in v) / 1e3:.3f} ms in {sum(x[2] for x in v)} launches"
              for k, v in mk.items()))
    for dt, key, count in rows[:20]:
        print(f"  {dt / 1e3:9.3f} ms {count:6d}  {key[:100]}")

    if args.schedule == "pool":
        if not args.loop:
            # the profiler does not see the kernels inside the WHILE node's
            # body: time one window's graph launch with CUDA events instead
            prog = r.programs.program
            pool, params = prog.state, cam.CameraParams.from_config(cfg, dev)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            spans = []
            for _ in range(5):
                pool.init(params, 0)
                start.record()
                prog.replay(1)
                end.record()
                torch.cuda.synchronize()
                spans.append(start.elapsed_time(end))
            print(f"one window's WHILE graph launch: device span ms {spans}, "
                  f"{int(pool.iterations)} iterations; best span over the best render "
                  f"wall {min(spans) / (1e3 * min(x.seconds for x in runs)):.3f}")
            # an iteration computes camera rays for every lane (and keeps the
            # refilled lanes'): their device time a call, inside a graph
            gid = torch.arange(pool.P, dtype=torch.int32, device=dev)
            d_ms, h_ms = event_ms(lambda: pool._fresh(gid))
            g_ms = graph_ms(lambda: pool._fresh(gid))
            print(f"camera rays for all {pool.P} lanes: device {g_ms:.3f} ms a call in a CUDA "
                  f"graph; eager span {d_ms:.3f} ms, host {h_ms:.3f} ms")
        return 0
    mega = r._get_mega(scene)
    derived = cam.derive(cfg, cam.CameraParams.from_config(cfg, dev))
    chunk = dict(n_block=r.n_block, spp_chunk=r.spp_chunk, has_moving=True, device=dev)
    d_ms, h_ms = event_ms(lambda: rmod.chunk_rays(cfg, derived, 0, 0, SEED, **chunk))
    print(f"camera rays per launch: device span {d_ms:.3f} ms, host {h_ms:.3f} ms")
    d_ms, h_ms = event_ms(lambda: rmod._render_chunk(
        mega, cfg, cam.pack_camera(derived), 0, 0, SEED, **r._chunk_kwargs(scene),
        phase_prefixes=pref,
        cull=r.cull))
    print(f"whole launch: device span {d_ms:.3f} ms, host {h_ms:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
