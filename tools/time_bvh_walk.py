"""The integrator's BVH walk (``ops/traverse.closest_hit_bvh``, plain
PyTorch) against the brute-force closest hit on the card.

    python3 tools/time_bvh_walk.py [--reps N] [--checks 1,4,16,64]

On bouncing_spheres at 400x225, 4 spp, depth 8 (``chip_smoke.py`` phase
26's configuration) it prints the card's name and power limit, then one
JSON line per ray set and check interval: the camera rays of the first
launch (B = 180,224) and the rays leaving their first bounce (the live
ones, after one brute-force bounce), each walked with the live-ray check
every ``k`` iterations (``traverse.CHECK_EVERY``) for each ``k`` of
``--checks``, in mirrored turns: wall ms through a synchronize (mean over
``--reps``), walk iterations and host syncs, and the brute-force hit on
the same rays. One profiled walk a ray set (at the default ``k``) gives
the device kernels a walk iteration launches and the device's busy share.
Then whole renders through ``hit_method="bvh"`` at each ``k`` and
``"brute"``, in turns, with their walls. Every walk's winners are held
equal to the brute force's (ties counted).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SEED = 7


def wall_ms(fn, reps):
    """(last output, mean wall ms of ``fn()`` through a synchronize)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--checks", default="1,4,16,64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from raytracing_tpu_torch import Renderer, build
    from raytracing_tpu_torch.ops import traverse
    from raytracing_tpu_torch.ops.intersect import T_MIN, closest_hit_brute
    from raytracing_tpu_torch.render import camera as cam
    from raytracing_tpu_torch.render import integrator
    from raytracing_tpu_torch.render.renderer import chunk_rays

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    checks = [int(x) for x in args.checks.split(",")]
    default_k = traverse.CHECK_EVERY
    scene, cfg = build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=4,
                       max_depth=8)
    r = Renderer(cfg, hit_method="bvh")
    derived = cam.derive(cfg, cam.CameraParams.from_config(cfg, dev))
    o, d, t, pix, smp, _, alive = chunk_rays(cfg, derived, 0, 0, SEED, n_block=r.n_block,
                                             spp_chunk=r.spp_chunk,
                                             has_moving=scene.flags.has_moving, device=dev)
    background = torch.tensor(cfg.background, dtype=torch.float32, device=dev)
    with torch.no_grad():
        st = integrator._bounce_once(scene, background, SEED, closest_hit_brute,
                                     integrator.initial_state(o, d, t, pix, smp, alive), 0)
    live = st[7]
    ray_sets = {"camera": (o, d, t), "bounce 1": (st[0][live], st[1][live], st[2][live])}

    ok = True
    with torch.no_grad():
        for name, (ro, rd, rt) in ray_sets.items():
            hb, brute_ms = wall_ms(lambda: closest_hit_brute(scene, ro, rd, rt, T_MIN),
                                   args.reps)
            turns = checks + checks[::-1]
            rows = {k: [] for k in checks}
            for k in turns:
                traverse.CHECK_EVERY = k
                traverse.reset_stats()
                hv, ms = wall_ms(lambda: traverse.closest_hit_bvh(scene, ro, rd, rt, T_MIN),
                                 args.reps)
                calls = traverse.stats["calls"]
                rows[k].append(dict(ms=round(ms, 3),
                                    iterations=traverse.stats["iterations"] // calls,
                                    syncs=traverse.stats["syncs"] // calls))
                same = hv.prim_id == hb.prim_id
                ok &= bool(torch.equal(hv.valid, hb.valid)) and bool(
                    torch.equal(hv.t[same], hb.t[same]))
            traverse.CHECK_EVERY = default_k
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as p:
                traverse.reset_stats()
                t0 = time.perf_counter()
                hv = traverse.closest_hit_bvh(scene, ro, rd, rt, T_MIN)
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in p.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            n_kernels = sum(e.count for e in kernels)
            busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            ties = int((hv.prim_id != hb.prim_id).sum())
            print(json.dumps({
                "rays": name, "B": int(ro.shape[0]), "brute_ms": round(brute_ms, 3),
                "walk_by_check_every": rows, "ties": ties,
                "profiled_walk": dict(check_every=default_k, wall_ms=round(prof_ms, 3),
                                      device_kernels=n_kernels,
                                      kernels_per_iteration=round(
                                          n_kernels / traverse.stats["iterations"], 1),
                                      device_busy_ms=round(busy_ms, 3),
                                      busy_share=round(busy_ms / prof_ms, 3)),
                "card": card}))

    renders = {}
    order = [("bvh", k) for k in checks] + [("brute", None)]
    for method, k in order + order[::-1]:
        if k is not None:
            traverse.CHECK_EVERY = k
        traverse.reset_stats()
        x = Renderer(cfg, hit_method=method).render(scene, seed=SEED)
        renders.setdefault(f"{method} k={k}" if k else method, []).append(
            dict(seconds=round(x.seconds, 4), segments=x.segments,
                 iterations_per_bounce=round(traverse.stats["iterations"]
                                             / max(traverse.stats["calls"], 1), 1),
                 syncs=traverse.stats["syncs"]))
    traverse.CHECK_EVERY = default_k
    segs = {v["segments"] for runs in renders.values() for v in runs}
    ok &= len(segs) == 1
    print(json.dumps({"renders": renders, "card": card}))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
