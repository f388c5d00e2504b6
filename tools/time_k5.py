"""K5's device time on full-width launches, checksummed, and its probe.

    python3 tools/time_k5.py [--root DIR] [--reps N] [--probe]

Imports raytracing_tpu_torch from DIR (default: this checkout), so a parent
commit unpacked beside it can be timed in the same call, in turns (one
process per checkout: parent, change, change, parent). Prints the card's
name and power limit first, then one JSON line per launch: K5 through
``trace_group`` on one full-width depth-20 launch (B = 180,224 camera
rays of a render's first launch) of bouncing_spheres_64 and of the bench
scene (bouncing_spheres 400x225, 100 spp) forced through the walk, and the
same launch of perlin_sphere and earth at their registry configurations
(depth 50); then the dense sweep on the bench scene, perlin_sphere and
earth. Each line has the device ms (CUDA events, mean over ``--reps``
launches after a warm-up), the segments and a checksum of the launch's
(rad, bounces, state): equal checksums from two checkouts mean they did
the same work, bit for bit.

``--probe`` (a checkout that has ``trace_group_probe``) then times the
probe's two designs (``megakernel_group.DESIGNS``: the baseline, the walk
before the guarded root and the node/leaf split, and K5's) on the walk
of bouncing_spheres_64 and the bench scene, each twice in mirrored
turns, with the checksum of its (rad, bounces, state); and runs the
counting instantiation of each: node visits, member tests, and the share
of a warp's 32 lanes active at a box test and at a member test.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

SEED = 7


def checksum(*tensors) -> str:
    """sha256 (16 hex digits) of the tensors' bytes, None skipped."""
    h = hashlib.sha256()
    for x in tensors:
        if x is not None:
            h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    pkg = importlib.import_module("raytracing_tpu_torch")
    mg = importlib.import_module("raytracing_tpu_torch.ops.megakernel_group")
    mk = importlib.import_module("raytracing_tpu_torch.ops.megakernel")
    kernels = importlib.import_module("raytracing_tpu_torch._kernels")
    smoke = importlib.import_module("chip_smoke")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"time_k5: {pkg.__file__} [{card}]")
    kernels.library()

    launches = {}
    scenes = {"bouncing_spheres_64": smoke.bouncing_spheres_64(dev),
              "bench": pkg.build("bouncing_spheres", device=dev, image_width=400,
                                 samples_per_pixel=100, max_depth=20),
              "perlin_sphere": pkg.build("perlin_sphere", device=dev),
              "earth": pkg.build("earth", device=dev)}
    for name, (scene, cfg) in scenes.items():
        r = pkg.Renderer(cfg, max_rays_per_launch=1 << 18)
        _, (ray_f, ray_i) = smoke.first_launch(scene, cfg, r.n_block, r.spp_chunk, dev)
        launches[name] = (mk.build_mega_scene(scene), ray_f, ray_i, cfg)

    def line(**kw):
        print(json.dumps(dict(kw, card=card)), flush=True)

    searches = [(name, "walk") for name in launches] + [
        (name, "sweep") for name in ("bench", "perlin_sphere", "earth")]
    for name, search in searches:
        mega, ray_f, ray_i, cfg = launches[name]
        kw = dict(max_depth=cfg.max_depth, background=cfg.background,
                  use_bvh=search == "walk")

        def run():
            return mg.trace_group(mega, ray_f, ray_i, SEED, 0, **kw)

        out = run()
        ms = smoke.cuda_ms(torch, run, args.reps)
        line(scene=name, search=search, B=ray_f.shape[1], depth=cfg.max_depth,
             segments=int(out[1].sum()), checksum=checksum(*out),
             checksum_rad_bounces=checksum(out[0], out[1]), ms=ms)

    if not args.probe:
        return 0
    probes = [(name, design) for name in ("bouncing_spheres_64", "bench")
              for design in mg.DESIGNS]
    order = probes + probes[::-1]  # in turns: each probe twice, mirrored
    times = {p: [] for p in probes}
    sums = {}
    for p in order:
        name, design = p
        mega, ray_f, ray_i, cfg = launches[name]
        kw = dict(max_depth=cfg.max_depth, background=cfg.background, design=design)

        def run():
            return mg.trace_group_probe(mega, ray_f, ray_i, SEED, 0, **kw)

        out = run()
        sums[p] = (int(out[1].sum()), checksum(*out[:3]))
        times[p].append(smoke.cuda_ms(torch, run, args.reps))
    for p in probes:
        name, design = p
        line(scene=name, search="walk", probe=design, segments=sums[p][0],
             checksum=sums[p][1], ms=times[p])
    for name in ("bouncing_spheres_64", "bench"):
        mega, ray_f, ray_i, cfg = launches[name]
        for design in mg.DESIGNS:
            _, bc, _, c = mg.trace_group_probe(mega, ray_f, ray_i, SEED, 0,
                                               max_depth=cfg.max_depth,
                                               background=cfg.background, design=design,
                                               count=True)
            seg = int(bc.sum())
            line(scene=name, search="walk", probe=design, counting=True, segments=seg, **c,
                 visits_per_segment=c["visits"] / seg,
                 member_tests_per_segment=(c["sphere_tests"] + c["quad_tests"]) / seg,
                 box_lane_share=c["box_lanes"] / (32 * c["box_issues"]),
                 member_lane_share=c["member_lanes"] / (32 * c["member_issues"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
