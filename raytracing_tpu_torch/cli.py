"""Command-line interface, the counterpart of ``raytracing_tpu.cli``:

    python -m raytracing_tpu_torch.cli render --scene cornell_box \
        --out output/cornell.ppm --width 600 --spp 100 --depth 50
    python -m raytracing_tpu_torch.cli scenes
    python -m raytracing_tpu_torch.cli bench

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``, the card;
``--device cpu`` runs the plain PyTorch versions on the CPU). Flags whose
features the port leaves out exit non-zero with a message:
``--clusters`` and ``--sort-regions`` other than 1 (TPU tuning knobs),
``--ray-order pixel`` and ``--spp-chunk`` (the launch shape is
sample-major only). ``--mode`` is accepted and has no effect: the
integrator always runs every bounce (``"scan"``), which gives the image
``"while"`` gives.

``--devices N`` renders through ``parallel.shard.render_sharded`` on a dp
mesh of N ranks (``raytracing_tpu/cli.py:77-82``), started by
``parallel.mesh.spawn``: NCCL with a card a rank when N is at most the
card count, else gloo (two ranks on one card; ``--device cpu``: gloo);
the JSONL log names the backend. The hit method is the ``Renderer``'s
(``--hit auto`` resolved on the scene), so the image is the single-device
command's. It takes none of ``--checkpoint``, ``--schedule pool``,
``--phases`` and ``--auto-prefix``, which belong to the single-device
``Renderer``.
"""
from __future__ import annotations

import argparse
import sys

from .core.device import DEFAULT_DEVICE


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="cornell_box", help="registry scene name")
    p.add_argument("--out", default="output/image.ppm", help=".ppm or .png path")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hit", default="auto", choices=["auto", "brute", "bvh", "mega"])
    p.add_argument("--mode", default="while", choices=["while", "scan"],
                   help="accepted for the JAX CLI's sake; no effect (every bounce runs, "
                        "which gives the same image)")
    p.add_argument("--checkpoint", default=None, help="resume/checkpoint file (npz)")
    p.add_argument("--trace-dir", default=None, help="torch.profiler trace output dir")
    p.add_argument("--log", default=None, help="JSONL log path")
    p.add_argument("--devices", type=int, default=0,
                   help="render on a dp mesh of N ranks (parallel/shard.py)")
    p.add_argument("--phases", default=None,
                   help="megakernel phase schedule, e.g. 2,3,15 (default: auto)")
    p.add_argument("--ray-order", default="sample", choices=["sample", "pixel"],
                   help="lane layout (only 'sample': the launches are sample-major)")
    p.add_argument("--spp-chunk", type=int, default=None,
                   help="samples per launch (refused: it goes with --ray-order pixel)")
    p.add_argument("--clusters", default=None, choices=["slab", "frustum", "list"],
                   help="refused: the TPU kernel's cluster culling is not ported")
    p.add_argument("--sort-regions", type=int, default=1,
                   help="refused unless 1: the TPU's regional sorts are not ported")
    p.add_argument("--schedule", default="phased", choices=["phased", "pool"],
                   help="phased launches (default) or the regenerating pool "
                        "(render/pool.py; no checkpoints)")
    p.add_argument("--auto-prefix", action="store_true",
                   help="plan per-phase live prefixes with an untimed counts pass, then "
                        "render with them (megakernel, phased schedule)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default: the card; 'cpu' for the plain versions)")


def _refusal(args) -> str | None:
    """Why the port cannot honour ``args``, or None."""
    if args.clusters is not None:
        return "--clusters: the TPU kernel's cluster culling is not ported"
    if args.sort_regions != 1:
        return "--sort-regions: the TPU's regional compaction sorts are not ported"
    if args.ray_order != "sample":
        return "--ray-order pixel: the port's launches are sample-major only"
    if args.spp_chunk is not None:
        return "--spp-chunk: the port sizes its launches itself (sample-major only)"
    if args.devices:
        for flag, on in (("--checkpoint", args.checkpoint is not None),
                         ("--schedule pool", args.schedule == "pool"),
                         ("--phases", args.phases is not None),
                         ("--auto-prefix", args.auto_prefix)):
            if on:
                return f"{flag} belongs to the single-device Renderer, not to --devices"
    return None


def cmd_render(args) -> int:
    from .models.scenes import build
    from .render.renderer import Renderer
    from .utils import checkpoint as ckpt
    from .utils.image_io import write_image
    from .utils.logging import JsonlLogger, scene_stats
    from .utils.profiling import trace_to

    overrides = {}
    if args.width:
        overrides["image_width"] = args.width
    if args.spp:
        overrides["samples_per_pixel"] = args.spp
    if args.depth:
        overrides["max_depth"] = args.depth

    log = JsonlLogger(args.log)
    scene, cfg = build(args.scene, device=args.device, **overrides)
    log.log("scene_compiled", scene=args.scene, **scene_stats(scene))

    if args.devices:
        with trace_to(args.trace_dir):
            _render_devices(args, scene, cfg, overrides, log)
        log.close()
        print(f"wrote {args.out}")
        return 0
    with trace_to(args.trace_dir):
        phases = [int(x) for x in args.phases.split(",")] if args.phases else None
        if args.auto_prefix and cfg.max_depth >= 12 and phases is None:
            phases = [2, 2, 3, 4, cfg.max_depth - 11]  # the bench schedule
        rkw = dict(hit_method=args.hit, phase_depths=phases, schedule=args.schedule)
        r = Renderer(cfg, **rkw)
        # prefixes belong to the megakernel's phased launches; planning
        # launches K1, and any failure there propagates
        if (args.auto_prefix and args.schedule == "phased"
                and r.resolve_hit_method(scene) == "mega"):
            pref = r.plan_phase_prefixes(scene, seed=args.seed)
            if pref is not None:
                r = Renderer(cfg, **rkw, phase_prefixes=pref)
        resume = ckpt.load_render_state(args.checkpoint) if args.checkpoint else None
        cb = ((lambda st: ckpt.save_render_state(args.checkpoint, st))
              if args.checkpoint else None)
        res = r.render(scene, seed=args.seed, progress=True, resume_state=resume,
                       checkpoint_cb=cb)
        write_image(args.out, res.radiance)
        log.log("render_done", out=args.out, segments=res.segments, seconds=res.seconds,
                rays_per_s=res.segments / max(res.seconds, 1e-9),
                hit_method=r.resolve_hit_method(scene), launches=res.launches)
    log.close()
    print(f"wrote {args.out}")
    return 0


def _render_devices(args, scene, cfg, overrides: dict, log) -> None:
    """``--devices N``: the render on a dp mesh of N spawned ranks."""
    import time

    from .entry import render_rank
    from .parallel.mesh import default_backend, spawn
    from .render.renderer import Renderer
    from .utils.image_io import write_image

    n = args.devices
    backend = default_backend(args.device, n)
    method = Renderer(cfg, hit_method=args.hit).resolve_hit_method(scene)
    t0 = time.perf_counter()
    radiance, segments = spawn(render_rank, n, backend=backend, device=args.device,
                               args=(args.scene, overrides, args.seed, method))[0]
    write_image(args.out, radiance)
    log.log("render_done", out=args.out, segments=segments, devices=n, backend=backend,
            hit_method=method, seconds=time.perf_counter() - t0)


def cmd_scenes(_args) -> int:
    from .models.scenes import SCENES

    for name in sorted(SCENES):
        print(name)
    return 0


def cmd_bench(_args) -> int:
    from . import bench

    bench.main([])
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="raytracing_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a registry scene")
    _add_render_args(pr)
    pr.set_defaults(fn=cmd_render)
    ps = sub.add_parser("scenes", help="list registry scenes")
    ps.set_defaults(fn=cmd_scenes)
    pb = sub.add_parser("bench", help="run the port's benchmark (raytracing_tpu_torch.bench)")
    pb.set_defaults(fn=cmd_bench)
    args = parser.parse_args(argv)
    if args.cmd == "render":
        why = _refusal(args)
        if why is not None:
            pr.error(why)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
