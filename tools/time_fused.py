"""The fused single dispatch against the launch loop on one CUDA device.

    python3 tools/time_fused.py [--reps N] [--config5] [--pool] [--out FILE]

For each path it runs the fused program (one chunk's ops captured once as
a CUDA graph and replayed once a chunk, ``render/graphs.py``) and the loop
(``fused=False``) after a warm-up of each, timed in turns (loop, fused,
fused, loop, ...), and checks that they agree:

* the bench render (bouncing_spheres 400x225, 100 spp, depth 20, seed 7,
  phases [2, 2, 3, 4, 9], planned prefixes, u8 transfer): u8 bytes and
  f32 radiance bit-equal, segments and ``ok`` equal, K1 launches counted;
* the prefix plan of that render: the same prefixes;
* bouncing_spheres_64 (chip_smoke.py's 64x64 grid, K5's walk): bit-equal;
* the bench's fwd+bwd sweep (``bench._fwd_bwd_setup``, 25 chunks): loss,
  segments and ``ok`` equal, gradients compared by relative L2 (the fold
  adds in a run-dependent order), peak device memory of each;
* with ``--config5``: BASELINE config 5 (bouncing_spheres 1200x675, 500
  spp, depth 50, the default Renderer): one render each way, and the
  fused and unfused fwd+bwd sweeps, with their peak memory.
* with ``--pool``, the regenerating pool instead (``Renderer(schedule=
  "pool")``: each sample window one launch of a CUDA graph whose WHILE
  node repeats a captured pool iteration, against the host loop): the
  bench render, bouncing_spheres_64, the textured registry scenes
  (perlin_sphere, simple_light, earth) and, with ``--config5``, config
  5 (25 windows of 20 spp); every fused render after its capture runs
  under ``torch.cuda.set_sync_debug_mode("error")`` up to its copy to
  the host (:func:`no_host_reads`), so a host read there raises.

Walls are host clocks through the copy to the host (``RenderResult.seconds``
for renders, which leaves out the one-time capture; the capture's seconds
are printed beside it). ``host_ms_per_replay`` is the host's time to issue
one replay, over a render's (sweep's) worth issued back to back. Prints
the card's name and power limit, then one JSON line per path; ``--out``
also writes them to FILE. ``chip_smoke.py`` phase 32 runs the same
functions.
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

SEED = 7
BENCH_PHASES = [2, 2, 3, 4, 9]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def _counters() -> dict:
    from raytracing_tpu_torch.diff import replay_kernel as rk
    from raytracing_tpu_torch.ops import megakernel_block as mb
    from raytracing_tpu_torch.ops import megakernel_group as mg
    from raytracing_tpu_torch.ops import table_gather as tg
    from raytracing_tpu_torch.ops import traverse

    return dict(K1=mb.launches, K5=mg.launches, K3=rk.fwd_launches, K2=rk.bwd_launches,
                K4=tg.launches, fold=tg.fold_launches, walk=traverse.launches,
                K1_camera=mb.camera_launches, camera_rays=rk.camera_launches)


def k_counts() -> dict:
    """The kernels' launches since the last :func:`_zero_counts`, as the
    wrappers counted them on the device."""
    return {k: int(count) for k, count in _counters().items()}


def _zero_counts() -> None:
    for count in _counters().values():
        count.reset()


def _peak(dev, fn):
    """(fn's result, peak bytes allocated during it)."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev)


def _host_ms_per_replay(prog, n: int) -> float:
    """Host milliseconds to issue one replay of ``prog``'s graph, over
    ``n`` replays issued back to back (the device catches up after)."""
    dev = prog.device
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    prog.replay(n)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    return 1e3 * dt / n


@contextlib.contextmanager
def no_host_reads(renderer, method: str = "_render_pool"):
    """Inside: ``renderer``'s ``method`` (by default its pool renders:
    every window's set-up and launch, the image's sums on the device; or
    ``"render"``, a whole render) runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so any host read there
    raises; only the final copy to the host (``graphs.to_host``) may
    synchronize."""
    from raytracing_tpu_torch.render import graphs

    real, real_to_host = getattr(renderer, method), graphs.to_host

    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def to_host(*tensors):
        torch.cuda.set_sync_debug_mode(0)
        return real_to_host(*tensors)

    setattr(renderer, method, strict)
    graphs.to_host = to_host
    try:
        yield
    finally:
        delattr(renderer, method)
        graphs.to_host = real_to_host


def compare_renders(scene, cfg, kw: dict, reps: int = 3) -> dict:
    """A fused and a looped ``Renderer(cfg, **kw)`` on ``scene``: one
    warm-up each (the fused one captures), then ``reps`` renders each in
    turns. Returns walls, capture seconds, the kernels' launches in one
    render of each, peak memory (the fused render's first, with its
    capture, and a later one), and whether images, segments and ``ok``
    agree bit for bit (u8 and f32). A pool's fused renders after the
    capture run inside :func:`no_host_reads`."""
    from raytracing_tpu_torch import Renderer

    dev = scene.spheres.radius.device
    rf = Renderer(cfg, **kw)
    rl = Renderer(cfg, **kw, fused=False)
    first, peak_f = _peak(dev, lambda: rf.render(scene, seed=SEED))
    capture_s = rf.programs.program.capture_seconds if rf.programs.program else 0.0
    pool = kw.get("schedule") == "pool"

    def strict(fused=True):
        return no_host_reads(rf) if pool and fused else contextlib.nullcontext()

    with strict():
        _, peak_f2 = _peak(dev, lambda: rf.render(scene, seed=SEED))
    _, peak_l = _peak(dev, lambda: rl.render(scene, seed=SEED))
    walls = {"fused": [], "loop": []}
    counts = {}
    res = {}
    for i in range(2 * reps):
        mode = ("loop", "fused", "fused", "loop")[i % 4]
        r = rf if mode == "fused" else rl
        _zero_counts()
        with strict(mode == "fused"):
            out = r.render(scene, seed=SEED)
        counts.setdefault(mode, k_counts())
        res.setdefault(mode, out)
        walls[mode].append(out.seconds)
    f, lp = res["fused"], res["loop"]
    host_ms = _host_ms_per_replay(rf.programs.program, f.launches)
    u8 = "transfer" in kw and kw["transfer"] == "u8"
    img_eq = bool((f.u8 == lp.u8).all()) if u8 else bool((f.radiance == lp.radiance).all())
    row = dict(segments=f.segments, segments_loop=lp.segments, ok=f.ok, ok_loop=lp.ok,
               launches=f.launches, image_equal=img_eq, first_image_equal=bool(
                   ((first.u8 == lp.u8).all()) if u8 else (first.radiance == lp.radiance).all()),
               walls_fused=walls["fused"], walls_loop=walls["loop"], capture_s=capture_s,
               counts_fused=counts["fused"], counts_loop=counts["loop"],
               host_ms_per_replay=host_ms, peak_bytes_first_fused=peak_f,
               peak_bytes_fused=peak_f2, peak_bytes_loop=peak_l)
    if u8:  # the f32 radiance too, through one more render each way
        f32 = {k: v for k, v in kw.items() if k != "transfer"}
        a = Renderer(cfg, **f32).render(scene, seed=SEED)
        b = Renderer(cfg, **f32, fused=False).render(scene, seed=SEED)
        row["f32_equal"] = bool((a.radiance == b.radiance).all()) and a.segments == b.segments
    row["equal"] = (img_eq and row["first_image_equal"] and f.segments == lp.segments
                    and f.ok == lp.ok and f.launches == lp.launches
                    and row.get("f32_equal", True))
    return row


def compare_plans(scene, cfg, kw: dict) -> dict:
    """The prefix plan fused and looped: prefixes, seconds, launches."""
    from raytracing_tpu_torch import Renderer

    out = {}
    for mode, fused in (("fused", True), ("loop", False)):
        _zero_counts()
        t0 = time.perf_counter()
        pref = Renderer(cfg, **kw, fused=fused).plan_phase_prefixes(scene, seed=SEED)
        out[mode] = dict(prefixes=pref, seconds=time.perf_counter() - t0, counts=k_counts())
    out["equal"] = out["fused"]["prefixes"] == out["loop"]["prefixes"]
    return out


def compare_sweeps(setup: dict, reps: int = 3) -> dict:
    """A planned ``bench._fwd_bwd_setup``'s sweep fused and unfused: one
    warm-up each (the fused one captures, peak memory of each), then
    ``reps`` sweeps each in turns, timed through the one host copy of
    (loss, gradients, segments, ok). Loss, segments and ok must be equal;
    the gradients are compared by relative L2."""
    from raytracing_tpu_torch.render import graphs

    dev = setup["device"]
    sweep = setup["sweep"]
    _, peak_f = _peak(dev, lambda: sweep(fused=True))
    capture_s = setup["programs"].program.capture_seconds
    _, peak_l = _peak(dev, lambda: sweep(fused=False))
    walls = {"fused": [], "loop": []}
    counts, res = {}, {}
    for i in range(2 * reps):
        mode = ("loop", "fused", "fused", "loop")[i % 4]
        _zero_counts()
        t0 = time.perf_counter()
        out = graphs.to_host(*sweep(fused=mode == "fused"))
        walls[mode].append(time.perf_counter() - t0)
        counts.setdefault(mode, k_counts())
        res.setdefault(mode, out)
    (lf, gcf, grf, sf, okf), (ll, gcl, grl, sl, okl) = res["fused"], res["loop"]
    host_ms = _host_ms_per_replay(setup["programs"].program, setup["n_chunks"])

    def rel(a, b):
        a, b = torch.from_numpy(a).double(), torch.from_numpy(b).double()
        return float((a - b).norm() / b.norm()) if float(b.norm()) > 0 else float((a - b).norm())

    return dict(loss=float(lf), loss_loop=float(ll), segments=int(sf), segments_loop=int(sl),
                ok=bool(okf), ok_loop=bool(okl), grad_center_rel_l2=rel(gcf, gcl),
                grad_rgb_rel_l2=rel(grf, grl), walls_fused=walls["fused"],
                walls_loop=walls["loop"], capture_s=capture_s, counts_fused=counts["fused"],
                counts_loop=counts["loop"], host_ms_per_replay=host_ms,
                peak_bytes_fused=peak_f, peak_bytes_loop=peak_l)


POOL_SCENES = ("perlin_sphere", "simple_light", "earth")


def compare_pools(dev, reps: int = 3, config5: bool = False) -> dict:
    """:func:`compare_renders` of the pool schedule (u8 transfer, one
    window) on the bench, bouncing_spheres_64 and :data:`POOL_SCENES` at
    their registry configurations, and with ``config5`` on BASELINE
    config 5 (f32, 25 windows of 20 spp; one render a mode)."""
    from chip_smoke import bouncing_spheres_64
    from raytracing_tpu_torch import build

    kw = dict(max_rays_per_launch=1 << 18, transfer="u8", schedule="pool")
    rows = {}
    scene, cfg = build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=100,
                       max_depth=20)
    rows["bench_pool"] = compare_renders(scene, cfg, kw, reps)
    scene, cfg = bouncing_spheres_64(dev)
    rows["bouncing_spheres_64_pool"] = compare_renders(scene, cfg, kw, reps)
    for name in POOL_SCENES:
        scene, cfg = build(name, device=dev)
        rows[f"{name}_pool"] = compare_renders(scene, cfg, kw, reps)
    del scene
    if config5:
        torch.cuda.empty_cache()
        scene, cfg = build("bouncing_spheres", device=dev, image_width=1200,
                           samples_per_pixel=500, max_depth=50)
        rows["config5_pool"] = compare_renders(scene, cfg, dict(schedule="pool"), 1)
        del scene
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--config5", action="store_true")
    ap.add_argument("--pool", action="store_true", help="the pool schedule's renders")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import bouncing_spheres_64
    from raytracing_tpu_torch import Renderer, _kernels, build
    from raytracing_tpu_torch import bench as pbench

    dev = torch.device("cuda", 0)
    name = card()
    print(f"time_fused: {name} torch {torch.__version__}")
    _kernels.library()
    if args.pool:
        return _report(name, compare_pools(dev, args.reps, args.config5), args.out)
    rows = {}
    scene, cfg = build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=100,
                       max_depth=20)
    kw = dict(hit_method="mega", max_rays_per_launch=1 << 18, transfer="u8",
              phase_depths=BENCH_PHASES)
    rows["bench_plan"] = compare_plans(scene, cfg, kw)
    pref = rows["bench_plan"]["fused"]["prefixes"]
    rows["bench_render"] = compare_renders(scene, cfg, dict(kw, phase_prefixes=pref), args.reps)
    s64, c64 = bouncing_spheres_64(dev)
    rows["bouncing_spheres_64_render"] = compare_renders(
        s64, c64, dict(max_rays_per_launch=1 << 18, transfer="u8",
                       phase_depths=[2, 2, 3, 4, c64.max_depth - 11]), args.reps)
    s = pbench._fwd_bwd_setup(device=dev)
    s["plan"]()
    rows["bench_sweep"] = compare_sweeps(s, args.reps)
    del s
    if args.config5:
        s5, c5 = build("bouncing_spheres", device=dev, image_width=1200, samples_per_pixel=500,
                       max_depth=50)
        rows["config5_render"] = compare_renders(s5, c5, {}, 1)
        torch.cuda.empty_cache()
        s = pbench._fwd_bwd_setup(width=1200, spp=500, max_depth=50, seed=SEED, spp_chunk=4,
                                  device=dev)
        s["plan"]()
        rows["config5_sweep"] = compare_sweeps(s, 1)
        del s
    return _report(name, rows, args.out)


def _report(name: str, rows: dict, out) -> int:
    for k, v in rows.items():
        print(f"{k}: {json.dumps(v)} [{name}]")
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(dict(card=name, rows=rows)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
