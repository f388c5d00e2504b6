"""The BASELINE acceptance configurations through the port, the
counterpart of ``tools/acceptance.py``:

1. single_sphere            200x100 @ 16 spp, depth 8
2. three_spheres            400x225 @ 64 spp, depth 16
3. bouncing_spheres (BVH)   400x225 @ 100 spp, depth 20
4. earth (image texture)    800x450 @ 256 spp, depth 50
5. bouncing_spheres         1200x675 @ 500 spp, depth 50, and the
   gradients of an MSE loss with respect to the albedos and the sphere
   centers (the fwd+bwd sweep, ``bench.bench_fwd_bwd``)

Each configuration renders through the default ``Renderer``
(``hit_method="auto"``): one cold render, then the best of ``--reps``
renders (the cold one included). One JSON line per configuration in the
JAX tool's schema (``segments``, ``seconds``, ``rays_per_s``,
``mean_u8``, ``nonblack_frac``, ``cold_seconds``, ``wall_s``, and
``grads`` for config 5), plus ``card`` (the card's name and power limit,
as ``nvidia-smi`` gives them) and, for config 5 on the card, the fwd+bwd
chunk's peak device memory. By default every configuration is scaled
down (``--scale``, 1/8 linear) as a smoke run; ``--full`` runs the exact
BASELINE shapes:

    python -m raytracing_tpu_torch.acceptance [--configs 1,3] [--full]
        [--scale S] [--reps N] [--device cpu]

A configuration that fails raises, and the run exits non-zero: nothing is
caught and printed as a result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .core.device import DEFAULT_DEVICE, resolve

# tools/acceptance.py:34-41
CONFIGS = {
    1: dict(scene="single_sphere", width=200, spp=16, depth=8),
    2: dict(scene="three_spheres", width=400, spp=64, depth=16),
    3: dict(scene="bouncing_spheres", width=400, spp=100, depth=20),
    4: dict(scene="earth", width=800, spp=256, depth=50),
    5: dict(scene="bouncing_spheres", width=1200, spp=500, depth=50, differentiable=True),
}


def _scaled(c: dict, scale: float) -> dict:
    """``tools/acceptance.py:44-51``: width, spp and depth cut for a smoke
    run (spp a multiple of 4, so config 5's gradient chunks divide it)."""
    c = dict(c)
    if scale != 1.0:
        c["width"] = max(32, int(c["width"] * scale))
        c["spp"] = max(4, int(c["spp"] * scale * scale * 16) // 4 * 4)
        c["depth"] = min(c["depth"], 8)
    return c


def card(device) -> str:
    """The card's name and power limit (``nvidia-smi``), or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id={dev.index or 0}"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip()


def run_config(n: int, c: dict, seed: int = 7, reps: int = 3, device=DEFAULT_DEVICE) -> dict:
    """``tools/acceptance.py:54-85``: configuration ``n`` rendered ``reps``
    times (the first one cold), its image statistics and the best time."""
    from .models.scenes import build
    from .render.renderer import Renderer

    dev = resolve(device)
    scene, cfg = build(c["scene"], device=dev, image_width=c["width"],
                       samples_per_pixel=c["spp"], max_depth=c["depth"])
    out = dict(config=n, scene=c["scene"], width=c["width"], spp=c["spp"], depth=c["depth"])
    r = Renderer(cfg)
    runs = [r.render(scene, seed=seed) for _ in range(max(1, reps))]
    res = min(runs, key=lambda x: x.seconds)
    u8 = res.image_u8
    out.update(
        cold_seconds=round(runs[0].seconds, 4),
        segments=int(res.segments),
        seconds=round(res.seconds, 4),
        rays_per_s=round(res.segments / max(res.seconds, 1e-9)),
        mean_u8=[round(float(m), 2) for m in u8.mean(axis=(0, 1))],
        nonblack_frac=round(float((u8.sum(-1) > 10).mean()), 4),
        hit_method=r.resolve_hit_method(scene),
        card=card(dev),
    )
    if c.get("differentiable"):
        out["grads"] = _grads(cfg, seed, reps, dev)
    return out


def _grads(cfg, seed: int, reps: int, device) -> dict:
    """``tools/acceptance.py:88-106``: config 5's gradients of an MSE pixel
    loss with respect to the texture rgbs and the sphere centers, by the
    fwd+bwd sweep (``bench.bench_fwd_bwd``: planning sweep, warm-up sweep,
    best of ``reps``), with the peak device memory of the run."""
    from . import bench

    spp = cfg.samples_per_pixel
    spp_chunk = next(k for k in (4, 2, 1) if spp % k == 0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    r = bench.bench_fwd_bwd(width=cfg.image_width, spp=spp, max_depth=cfg.max_depth, seed=seed,
                            spp_chunk=spp_chunk, device=device, reps=max(1, reps))
    out = dict(rays_per_s=round(r["rays_per_s"]), segments=int(r["segments"]),
               seconds=round(r["seconds"], 3), grads_finite=r["grads_finite"],
               spp_chunk=spp_chunk)
    if device.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytracing_tpu_torch.acceptance")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--full", action="store_true", help="the exact BASELINE shapes")
    ap.add_argument("--scale", type=float, default=0.125,
                    help="linear down-scale of the smoke run")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=3, help="renders a configuration, best kept")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    scale = 1.0 if args.full else args.scale
    for n in [int(x) for x in args.configs.split(",")]:
        c = _scaled(CONFIGS[n], scale)
        t0 = time.time()
        out = run_config(n, c, seed=args.seed, reps=args.reps, device=args.device)
        out["wall_s"] = round(time.time() - t0, 1)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
