"""The integrator's BVH walk on the card: the kernel (``rt_bvh_walk``,
``ops/traverse.walk``) beside the plain lockstep walk and the brute-force
closest hit, and whole renders through ``hit_method="bvh"``.

    python3 tools/time_bvh_walk.py [--reps N] [--checks 1,16] [--full]

On bouncing_spheres at 400x225, 4 spp, depth 8 (``chip_smoke.py`` phase
26's cut configuration) it prints the card's name and power limit, then
one JSON line per ray set (``tests/torch_parity.bvh_ray_sets``): the
camera rays of the first launch (B = 180,224) and the rays leaving their
first bounce (the live ones, after one brute-force bounce). Each line
has the kernel's device ms (its launch alone, queued behind a spin
kernel: ``chip_smoke.device_ms``), its
winners and ``t`` against the plain walk's (bit for bit), its bound
(``chip_smoke.bound``: operations counted from the plain walk's visits,
sphere tests and quad tests on the same rays, bytes as o, d, time in and
t, prim out); the plain walk's wall ms with its live-ray check every
``k`` iterations for each ``k`` of ``--checks`` (``traverse.CHECK_EVERY``:
the plain walk's only; the kernel reads nothing back), its iterations and
host syncs; and the brute-force hit's wall ms, with
``closest_hit_bvh`` (the kernel) against it: validity equal, ``t``
bit-equal where the primitive is the same, ties counted. Then whole
renders, in turns: ``"bvh"`` fused (the default; after its capture each
render runs under ``torch.cuda.set_sync_debug_mode("error")`` until its
copy to the host: ``time_fused.no_host_reads``), ``"bvh"`` looped
(``fused=False``) and ``"brute"`` fused, with walls, segments and the
walk's launches, fused and looped held bit-equal. ``--full`` adds the
bench configuration (400x225, 100 spp, depth 20) through ``"bvh"``
fused: walls and, from one render under torch.profiler, the device's
busy share and the walk's device time. ``chip_smoke.py`` phase 26 runs
the same functions.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from time_fused import no_host_reads  # noqa: E402

SEED = 7
# FP32 operations, counted from csrc/bvh_walk.cu (each add, multiply,
# compare, min, max, select, sqrt or divide as one; about ±20%)
OPS_PER_VISIT = 27      # 6 sub, 6 mul, 6 min/max a pair, 4 to reduce, 2 clamps, test, link
OPS_PER_SPHERE = 40     # moving centre 6, oc 3, b 5, c 6, disc 3, sqrt, roots 5, tests 8, best 2
OPS_PER_QUAD = 62       # denom 5, plane t 7, point 6, alpha 14, beta 14, tests 14, best 2
BYTES_PER_RAY = 40      # o, d, time in (28); t, best_prim out (12)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def wall_ms(fn, reps):
    """(last output, mean wall ms of ``fn()`` through a synchronize)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def walk_row(scene, o, d, t, reps: int = 20, checks=(16,)) -> dict:
    """The kernel against the plain walk and brute force on one ray set."""
    import chip_smoke
    from raytracing_tpu_torch import _kernels
    from raytracing_tpu_torch.ops import traverse
    from raytracing_tpu_torch.ops.intersect import BIG, T_MIN, closest_hit_brute

    B = o.shape[0]
    lib = _kernels.library().lib
    _alive, args = traverse.kernel_args(scene, o, d, t, T_MIN, BIG)  # kept while timed
    prim = torch.empty(B, dtype=torch.int64, device=o.device)
    tb = torch.empty(B, dtype=torch.float32, device=o.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.rt_bvh_walk(*args, prim.data_ptr(), tb.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"rt_bvh_walk: {lib.rt_error_string(err).decode()}")

    kernel_ms = chip_smoke.device_ms(torch, launch, reps)
    with torch.no_grad():
        k_prim, k_t = traverse.walk(scene, o, d, t)
        counts = torch.zeros((3, B), dtype=torch.int64, device=o.device)
        default_k = traverse.CHECK_EVERY
        plain = {}
        try:
            for k in [*checks, *checks[::-1]]:
                traverse.CHECK_EVERY = k
                traverse.reset_stats()
                (p_prim, p_t), ms = wall_ms(lambda: traverse._traverse(scene, o, d, t, T_MIN,
                                                                       BIG), 1)
                row = plain.setdefault(k, dict(ms=[], iterations=traverse.stats["iterations"] // 2,
                                               syncs=traverse.stats["syncs"] // 2))
                row["ms"].append(round(ms, 3))
        finally:
            traverse.CHECK_EVERY = default_k
        traverse._traverse(scene, o, d, t, T_MIN, BIG, counts=counts)
        hb, brute_ms = wall_ms(lambda: closest_hit_brute(scene, o, d, t, T_MIN), 3)
        before = int(traverse.launches)
        hv = traverse.closest_hit_bvh(scene, o, d, t, T_MIN)
        hit_launches = int(traverse.launches) - before
    visits, spheres, quads = (int(x) for x in counts.sum(dim=1))
    ops = visits * OPS_PER_VISIT + spheres * OPS_PER_SPHERE + quads * OPS_PER_QUAD
    bound_ms, bound_by = chip_smoke.bound(ops, B * BYTES_PER_RAY)
    same = hv.prim_id == hb.prim_id
    return dict(
        B=B, kernel_ms=kernel_ms, plain_ms_by_check=plain, brute_ms=brute_ms,
        bit_equal=bool(torch.equal(k_prim, p_prim) and torch.equal(k_t, p_t)),
        max_abs_err=float((k_t - p_t).abs().nan_to_num(0.0).max()) if B else 0.0,
        valid_equal=bool(torch.equal(hv.valid, hb.valid)),
        t_equal_where_same=bool(torch.equal(hv.t[same], hb.t[same])),
        ties=int((~same).sum()), hit_launches=hit_launches, visits=visits,
        sphere_tests=spheres, quad_tests=quads, visits_per_ray=visits / max(B, 1),
        bound_ms=bound_ms, bound_by=bound_by)


def render_rows(scene, cfg) -> dict:
    """``"bvh"`` fused (strict after its capture), ``"bvh"`` looped and
    ``"brute"`` fused, two renders each in mirrored turns after a warm-up
    each: walls, segments, the walk's launches a render, and whether
    fused and looped agree bit for bit."""
    from raytracing_tpu_torch import Renderer
    from raytracing_tpu_torch.ops import traverse

    r = {"bvh fused": Renderer(cfg, hit_method="bvh"),
         "bvh loop": Renderer(cfg, hit_method="bvh", fused=False),
         "brute fused": Renderer(cfg, hit_method="brute")}
    for x in r.values():
        x.render(scene, seed=SEED)  # warm-up; the fused ones capture
    rows = {k: dict(walls=[], walk_launches=[]) for k in r}
    res = {}
    order = list(r)
    for name in order + order[::-1]:
        ctx = (no_host_reads(r[name], "render") if name == "bvh fused"
               else contextlib.nullcontext())
        traverse.launches.reset()
        with ctx:
            out = r[name].render(scene, seed=SEED)
        rows[name]["walls"].append(out.seconds)
        rows[name]["walk_launches"].append(int(traverse.launches))
        res.setdefault(name, out)
    f, lp, br = res["bvh fused"], res["bvh loop"], res["brute fused"]
    for name, out in res.items():
        rows[name].update(segments=out.segments, launches=out.launches)
    rows["bvh fused"]["capture_s"] = r["bvh fused"].programs.program.capture_seconds
    return dict(rows=rows, fused_equals_loop=bool(
        (f.radiance == lp.radiance).all() and f.segments == lp.segments
        and f.launches == lp.launches), mean_abs_err_vs_brute=float(
        abs(f.radiance - br.radiance).mean()), radiance=f.radiance)


def full_width(scene, cfg, reps: int = 2) -> dict:
    """``"bvh"`` fused at ``cfg``: walls after the capture, the walk's
    launches a render, and one render under torch.profiler: the device's
    busy share (kernel time over the render's wall) and the walk's
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_tpu_torch import Renderer
    from raytracing_tpu_torch.ops import traverse

    r = Renderer(cfg, hit_method="bvh")
    r.render(scene, seed=SEED)  # captures
    walls = []
    for _ in range(reps):
        traverse.launches.reset()
        with no_host_reads(r, "render"):
            out = r.render(scene, seed=SEED)
        walls.append(out.seconds)
    launches = int(traverse.launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        r.render(scene, seed=SEED)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    kernels = [e for e in p.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    walk = [e for e in kernels if "bvh_walk" in e.key]
    return dict(walls=walls, segments=out.segments, launches=out.launches,
                walk_launches=launches, capture_s=r.programs.program.capture_seconds,
                profiled_wall_s=prof_s, device_busy_ms=busy_ms,
                busy_share=busy_ms / (prof_s * 1e3),
                walk_device_ms=sum(e.self_device_time_total for e in walk) / 1e3,
                walk_kernels_profiled=sum(e.count for e in walk), radiance=out.radiance)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--checks", default="1,16")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from raytracing_tpu_torch import _kernels, build

    c = card()
    print(f"card: {c}")
    _kernels.library()
    dev = torch.device("cuda", 0)
    scene, cfg = build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=4,
                       max_depth=8)
    checks = tuple(int(x) for x in args.checks.split(","))
    ok = True
    from torch_parity import bvh_ray_sets

    for name, rays in bvh_ray_sets(scene, cfg, SEED).items():
        row = walk_row(scene, *rays, reps=args.reps, checks=checks)
        ok &= (row["bit_equal"] and row["valid_equal"] and row["t_equal_where_same"]
               and row["ties"] <= row["B"] // 1000)
        print(json.dumps({"rays": name, **row, "card": c}))
    rr = render_rows(scene, cfg)
    rr.pop("radiance")
    ok &= rr["fused_equals_loop"] and rr["mean_abs_err_vs_brute"] < 2e-3
    print(json.dumps({"renders": rr, "card": c}))
    if args.full:
        scene, cfg = build("bouncing_spheres", device=dev, image_width=400,
                           samples_per_pixel=100, max_depth=20)
        fw = full_width(scene, cfg)
        fw.pop("radiance")
        print(json.dumps({"full_width": fw, "card": c}))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
