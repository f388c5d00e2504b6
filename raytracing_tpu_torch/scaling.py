"""Data-parallel scaling of the sharded render, the counterpart of
``tools/scaling.py`` (``run``, ``:35-90``): traced segments per second of
``parallel.shard.build_sharded_renderer`` on a dp mesh of N ranks
(bouncing_spheres; the best of ``--reps`` renders after one warm-up),
one JSON line per mesh size and a summary line.

    python -m raytracing_tpu_torch.scaling [--sizes 1 2 4] [--width 200]
        [--spp 16] [--depth 8] [--hit bvh] [--device cuda|cpu]

Each size spawns its ranks (``parallel.mesh.spawn``): NCCL with a card a
rank when there are enough cards, else gloo. Efficiency, rate_N / (N ·
rate_1), is reported only when every rank has a card of its own; ranks
that share a card (or the CPU's cores) cannot scale by construction, so
their rates are written down with ``"ranks_share_a_device": true`` and an
efficiency of null.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .core.device import DEFAULT_DEVICE, resolve


def _rate_rank(device, width: int, spp: int, max_depth: int, seed: int, hit_method: str,
               reps: int) -> dict:
    """One rank's timed renders: the best wall of ``reps`` renders after a
    warm-up, each ending with the image on the host."""
    from .models.scenes import build
    from .parallel.mesh import barrier, make_mesh
    from .parallel.shard import build_sharded_renderer
    from .render.camera import CameraParams

    mesh = make_mesh(device=device)
    scene, cfg = build("bouncing_spheres", device=mesh.device, image_width=width,
                       samples_per_pixel=spp, max_depth=max_depth)
    fn, prep, _ = build_sharded_renderer(scene, cfg, mesh, hit_method=hit_method)
    params = CameraParams.from_config(cfg, mesh.device)
    best, segments = None, 0
    with torch.no_grad():
        fn(prep, params, seed)[0].cpu()  # warm-up: the kernels' build, allocator
        for _ in range(reps):
            barrier(mesh)
            t0 = time.perf_counter()
            part, segments = fn(prep, params, seed)
            part.cpu()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
    return dict(segments=segments, seconds=best)


def rate(n: int, width: int = 200, spp: int = 16, max_depth: int = 8, seed: int = 7,
         hit_method: str = "bvh", reps: int = 3, device=DEFAULT_DEVICE) -> dict:
    """Segments per second of the render on a dp mesh of ``n`` ranks (rank
    0's best wall), with the backend and whether the ranks share a
    device."""
    from .parallel.mesh import default_backend, spawn

    backend = default_backend(resolve(device), n)
    own_cards = backend == "nccl"
    r = spawn(_rate_rank, n, backend=backend, device=device,
              args=(width, spp, max_depth, seed, hit_method, reps))[0]
    return dict(devices=n, rays_per_s=r["segments"] / r["seconds"], segments=r["segments"],
                seconds=r["seconds"], backend=backend,
                ranks_share_a_device=not own_cards and n > 1)


def run(sizes, width=200, spp=16, max_depth=8, seed=7, hit_method="bvh", reps=3,
        device=DEFAULT_DEVICE) -> dict:
    """One line per mesh size, then the summary (``tools/scaling.py``'s
    schema); returns the summary."""
    dev = resolve(device)
    rows, r1 = [], None
    for n in sizes:
        row = rate(n, width, spp, max_depth, seed, hit_method, reps, dev)
        if n == 1:
            r1 = row["rays_per_s"]
        row["efficiency"] = (round(row["rays_per_s"] / (n * r1), 4)
                             if r1 and not row["ranks_share_a_device"] else None)
        row["rays_per_s"] = round(row["rays_per_s"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    effs = [r["efficiency"] for r in rows if r["devices"] > 1]
    summary = dict(metric="scaling_efficiency_dp", backend=dev.type, target=0.85, rows=rows,
                   ok=(all(e >= 0.85 for e in effs) if effs and None not in effs else None))
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytracing_tpu_torch.scaling")
    ap.add_argument("--sizes", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--width", type=int, default=200)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--hit", default="bvh", choices=["brute", "bvh", "mega"])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    run(args.sizes, args.width, args.spp, args.depth, args.seed, args.hit, args.reps,
        args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
