"""K1's device time by search, on the launches of its main paths.

    python3 tools/time_k1.py [--root DIR] [--reps N] [--renders N]

Imports raytracing_tpu_torch from DIR (default: this checkout), so a parent
commit unpacked beside it can be timed in the same call, in turns. Times,
with CUDA events over ``--reps`` launches after a warm-up, K1 on:

* one full-width depth-20 launch of the bench scene (bouncing_spheres,
  B = 180,224 camera rays of the bench render's first launch);
* the same launch of bouncing_spheres_64 (chip_smoke.py's 64x64 grid)
  and of perlin_sphere (the marble scene at its registry size, depth 50);
* a pool-shaped launch of each: the same rays with per-ray depths in
  [0, depth) drawn from a seed, 2 bounces, depth cap the scene's depth;
* the first launch of next_week_final as its benchmark cell renders it
  (800x800, 250 spp: B = 262,144, depth 40, the walk), with its two
  participating media and built without them, so that the media's cost
  shows alone (full width only: the pool refuses media; skipped where the
  package has no such scene).

Each search the package's ``trace_block`` offers is timed: the sweep and
the walk (``cull=False``/``True``) where it takes ``cull``, else its one
search. Prints the card's name and power limit, then one JSON line per
launch and search with the segments traced, so that two checkouts can be
checked for the same work. With ``--renders N`` it then times the bench
render (400x225, 100 spp, depth 20, seed 7, u8 transfer) N times in each
schedule, in turns: the phased one ([2, 2, 3, 4, 9] with planned
prefixes) and the pool, and perlin_sphere's pool render (its registry
size) beside them, after a warm-up of each (host clock through the copy
of the image to the host, as ``RenderResult.seconds``), and prints a
hash of each render's u8 image and of the bench schedules' f32 images.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SEED = 7


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--renders", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    pkg = importlib.import_module("raytracing_tpu_torch")
    mb = importlib.import_module("raytracing_tpu_torch.ops.megakernel_block")
    mk = importlib.import_module("raytracing_tpu_torch.ops.megakernel")
    kernels = importlib.import_module("raytracing_tpu_torch._kernels")
    smoke = importlib.import_module("chip_smoke")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"time_k1: {pkg.__file__} [{card}]")
    kernels.library()
    searches = ({"sweep": dict(cull=False), "walk": dict(cull=True)}
                if "cull" in inspect.signature(mb.trace_block).parameters
                else {"sweep": {}})
    bench = pkg.build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=100,
                      max_depth=20)
    marble = pkg.build("perlin_sphere", device=dev)
    for name, (scene, cfg) in (("bench", bench),
                               ("bouncing_spheres_64", smoke.bouncing_spheres_64(dev)),
                               ("perlin_sphere", marble)):
        mega = mk.build_mega_scene(scene)
        r = pkg.Renderer(cfg, max_rays_per_launch=1 << 18)
        _, (ray_f, ray_i) = smoke.first_launch(scene, cfg, r.n_block, r.spp_chunk, dev)
        B = ray_f.shape[1]
        dep = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.max_depth, B).astype(np.int32)).to(dev)
        launches = {"full width": dict(max_depth=cfg.max_depth),
                    "pool-shaped": dict(max_depth=2, depth_cap=cfg.max_depth, dep=dep)}
        for shape, kw in launches.items():
            for search, ckw in searches.items():
                def run():
                    return mb.trace_block(mega, ray_f, ray_i, SEED, 0, background=cfg.background,
                                          **kw, **ckw)

                seg = int(run()[1].sum())
                ms = smoke.cuda_ms(torch, run, args.reps)
                print(json.dumps(dict(scene=name, launch=shape, search=search, B=B,
                                      segments=seg, ms=ms, card=card)))
    final = None
    try:
        final = {media: pkg.build("next_week_final", device=dev, samples_per_pixel=250,
                                  media=media) for media in (True, False)}
    except KeyError:
        print(json.dumps(dict(scene="next_week_final", skipped="not in this package's registry")))
    for media, (scene, cfg) in (final or {}).items():
        mega = mk.build_mega_scene(scene)
        r = pkg.Renderer(cfg)
        _, (ray_f, ray_i) = smoke.first_launch(scene, cfg, r.n_block, r.spp_chunk, dev)

        def run():
            return mb.trace_block(mega, ray_f, ray_i, SEED, 0, background=cfg.background,
                                  max_depth=cfg.max_depth)

        seg = int(run()[1].sum())
        ms = smoke.cuda_ms(torch, run, args.reps)
        print(json.dumps(dict(scene="next_week_final" if media else "next_week_final no media",
                              launch="full width", search="walk", B=ray_f.shape[1],
                              segments=seg, ms=ms, ns_per_segment=1e6 * ms / seg, card=card)))
    if args.renders:
        scene, cfg = bench
        kw = dict(max_rays_per_launch=1 << 18, transfer="u8")
        phased = dict(kw, phase_depths=[2, 2, 3, 4, cfg.max_depth - 11])
        pref = pkg.Renderer(cfg, **phased).plan_phase_prefixes(scene, seed=SEED)
        renderers = {"phased": (pkg.Renderer(cfg, **phased, phase_prefixes=pref), scene),
                     "pool": (pkg.Renderer(cfg, **kw, schedule="pool"), scene),
                     "perlin_sphere pool": (pkg.Renderer(marble[1], transfer="u8",
                                                         schedule="pool"), marble[0])}
        seconds = {k: [] for k in renderers}
        segments = {k: r.render(sc, seed=SEED).segments for k, (r, sc) in renderers.items()}
        for _ in range(args.renders):
            for k, (r, sc) in renderers.items():
                seconds[k].append(r.render(sc, seed=SEED).seconds)
        # the images' bytes, u8 and f32, for two checkouts to compare
        sha = {k: hashlib.sha256(r.render(sc, seed=SEED).u8.tobytes()).hexdigest()[:16]
               for k, (r, sc) in renderers.items()}
        sha_f32 = {k: hashlib.sha256(pkg.Renderer(cfg, **{**kw, **extra, "transfer": "f32"})
                                     .render(scene, seed=SEED).radiance.tobytes()).hexdigest()[:16]
                   for k, extra in (("phased", dict(phased, phase_prefixes=pref)),
                                    ("pool", dict(schedule="pool")))}
        print(json.dumps(dict(scene="bench", renders=seconds, segments=segments, u8_sha256=sha,
                              f32_sha256=sha_f32, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
