#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (raytracing_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phase 1 builds the CUDA kernels from raytracing_tpu_torch/csrc with nvcc.
Phase 2 holds K1 against its plain PyTorch version on the card
(three_spheres, cornell_box, bouncing_spheres). Phase 3 renders the bench
workload (bouncing_spheres 400x225, 100 spp, depth 20, seed 7) through
Renderer with the [2,2,3,4,9] schedule and planned prefixes, counts K1's
launches in that render and checks the segment count; it also holds a
small render on the card against the same render on the CPU. Phase 4
times K1 and its plain version on one full-width launch.

Prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}. Exits
non-zero, without that line, when there is no CUDA device or any phase
fails. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

BENCH_SEGMENTS = 24_280_645  # bench workload's traced segments (JAX reference)
SEED = 7


def segments_close(ref: int, s: int) -> bool:
    return abs(int(ref) - int(s)) <= max(4, int(ref) // 200)


def first_launch(scene, cfg, n_block, spp_chunk, dev):
    """Camera rays of a render's first launch (n_block pixels ×
    spp_chunk samples), and the same rays as K1's packed inputs."""
    from raytracing_tpu_torch.ops.megakernel import pack_rays
    from raytracing_tpu_torch.render import camera as cam
    from raytracing_tpu_torch.render.renderer import chunk_rays

    derived = cam.derive(cfg, cam.CameraParams.from_config(cfg, dev))
    o, d, t, pix, smp, _, alive = chunk_rays(
        cfg, derived, 0, 0, SEED, n_block=n_block, spp_chunk=spp_chunk,
        has_moving=scene.flags.has_moving, device=dev)
    return (o, d, t, pix, smp, alive), pack_rays(o, d, t, pix, smp, alive)


def compare(torch, mb, exact, ref, out, n):
    """(ok, stats) for K1 outputs ``out`` against ``ref`` (each (rad,
    bounces, state)), with the JAX reference's bars."""
    diff = (out[0] - ref[0]).abs()
    s_ref, s_out = int(ref[1].sum()), int(out[1].sum())
    stats = dict(max_abs_err=float(diff.max()), mean_abs_err=float(diff.mean()),
                 segments=s_out, segments_plain=s_ref)
    ok = segments_close(s_ref, s_out)
    ok &= (stats["max_abs_err"] < 1e-5) if exact else (stats["mean_abs_err"] < 2e-3)
    if ref[2] is not None:
        rows = [mb.OX, mb.OY, mb.OZ, mb.DX, mb.DY, mb.DZ, mb.TR, mb.TG, mb.TB, mb.ACT]
        r, o = ref[2][rows], out[2][rows]
        bad = ((o - r).abs() > 1e-3 * torch.clamp(r.abs(), min=1.0)).any(0) | (ref[1] != out[1])
        stats["state_rays_disagreeing"] = int(bad.sum())
        ok &= stats["state_rays_disagreeing"] <= (n // 20 if not exact else max(4, n // 200))
    return bool(ok), stats


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from raytracing_tpu_torch import Renderer, _kernels, build
    from raytracing_tpu_torch.ops import megakernel_block as mb
    from raytracing_tpu_torch.ops.megakernel import build_mega_scene, trace_megakernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    k = _kernels.library()
    print(f"phase 1 build: nvcc {k.build_seconds:.2f} s, load {time.perf_counter() - t0:.2f} s "
          f"({k.path.name})")
    for line in k.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    failures = []

    # ---- phase 2: K1 against the plain version, small launches ----
    for name, exact in (("three_spheres", True), ("cornell_box", True),
                        ("bouncing_spheres", False)):
        scene, cfg = build(name, device=dev, image_width=64, samples_per_pixel=2, max_depth=6)
        mega = build_mega_scene(scene)
        n_block = -(-cfg.n_pixels // 1024) * 1024
        _, (ray_f, ray_i) = first_launch(scene, cfg, n_block, 2, dev)
        for b_off in (0, 3):
            args = (mega, ray_f, ray_i, SEED, b_off)
            kw = dict(max_depth=6, background=cfg.background)
            out = mb.trace_block(*args, **kw)
            torch.cuda.synchronize()
            ref = mb.trace_block_torch(*args, **kw)
            ok, stats = compare(torch, mb, exact, ref, out, ray_f.shape[1])
            print(f"phase 2 {name} b_off={b_off} B={ray_f.shape[1]}: "
                  f"{'ok' if ok else 'FAIL'} {json.dumps(stats)}")
            if not ok:
                failures.append(f"phase 2 {name} b_off={b_off}")

    # ---- phase 3: the bench render through Renderer ----
    scene, cfg = build("bouncing_spheres", device=dev, image_width=400,
                       samples_per_pixel=100, max_depth=20)
    kw = dict(hit_method="mega", max_rays_per_launch=1 << 18, transfer="u8",
              phase_depths=[2, 2, 3, 4, cfg.max_depth - 11])
    t0 = time.perf_counter()
    pref = Renderer(cfg, **kw).plan_phase_prefixes(scene, seed=SEED)
    print(f"phase 3 plan: prefixes {pref} in {time.perf_counter() - t0:.2f} s")
    r = Renderer(cfg, **kw, phase_prefixes=pref)
    r.render(scene, seed=SEED)  # warm-up: allocator and CUDA libraries
    mb.launches = 0
    res = r.render(scene, seed=SEED)
    k1_launches = mb.launches
    runs = [res] + [r.render(scene, seed=SEED) for _ in range(2)]
    best = min(runs, key=lambda x: x.seconds)
    img = res.u8
    render_ok = (res.ok is True and k1_launches > 0
                 and segments_close(BENCH_SEGMENTS, res.segments)
                 and all(x.segments == res.segments for x in runs)
                 and img.shape == (cfg.image_height, cfg.image_width, 3)
                 and 20 < float(img.mean()) < 235)
    print(f"phase 3 render: {'ok' if render_ok else 'FAIL'} segments {res.segments} "
          f"(reference {BENCH_SEGMENTS}) launches {res.launches} k1_launches {k1_launches} "
          f"ok {res.ok} seconds {[round(x.seconds, 4) for x in runs]} "
          f"best {best.seconds:.4f} s {best.segments / best.seconds:.4g} rays/s "
          f"image mean {float(img.mean()):.2f} [{card}]")
    if not render_ok:
        failures.append("phase 3 bench render")

    small = dict(image_width=48, samples_per_pixel=2, max_depth=8)
    s_gpu, c_gpu = build("bouncing_spheres", device=dev, **small)
    s_cpu, c_cpu = build("bouncing_spheres", **small)
    g = Renderer(c_gpu, phase_depths=[2, 2, 4]).render(s_gpu, seed=SEED)
    c = Renderer(c_cpu, phase_depths=[2, 2, 4]).render(s_cpu, seed=SEED)
    mean_err = float(abs(g.radiance - c.radiance).mean())
    small_ok = mean_err < 2e-3 and segments_close(c.segments, g.segments)
    print(f"phase 3 small render card vs cpu: {'ok' if small_ok else 'FAIL'} "
          f"mean_abs_err {mean_err:.3g} segments {g.segments} cpu {c.segments}")
    if not small_ok:
        failures.append("phase 3 small render")

    # ---- phase 4: K1 against the plain version on one full-width launch ----
    mega = build_mega_scene(scene)
    (o, d, t, pix, smp, alive), (ray_f, ray_i) = first_launch(scene, cfg, r.n_block,
                                                              r.spp_chunk, dev)
    B = ray_f.shape[1]
    args = (mega, ray_f, ray_i, SEED, 0)
    kw4 = dict(max_depth=cfg.max_depth, background=cfg.background)
    out = mb.trace_block(*args, **kw4)
    ref = mb.trace_block_torch(*args, **kw4)
    ok4, stats = compare(torch, mb, False, ref, out, B)
    ms = cuda_ms(torch, lambda: mb.trace_block(*args, **kw4), 5)
    plain_ms = cuda_ms(torch, lambda: mb.trace_block_torch(*args, **kw4), 2)
    print(f"phase 4 single launch B={B} depth {cfg.max_depth}: {'ok' if ok4 else 'FAIL'} "
          f"{json.dumps(stats)} kernel {ms:.3f} ms plain {plain_ms:.3f} ms [{card}]")
    if not ok4:
        failures.append("phase 4 single launch")

    phased = dict(phase_depths=kw["phase_depths"], active0=alive)
    trace_args = (mega, o, d, t, pix, smp, cfg.background, cfg.max_depth, SEED)
    rad_k, seg_k = trace_megakernel(*trace_args, **phased)
    rad_p, seg_p = trace_megakernel(*trace_args, **phased, block_fn=mb.trace_block_torch)
    err = float((rad_k - rad_p).abs().mean())
    ph_ok = err < 2e-3 and segments_close(int(seg_p), int(seg_k))
    ph_ms = cuda_ms(torch, lambda: trace_megakernel(*trace_args, **phased), 5)
    ph_plain_ms = cuda_ms(torch, lambda: trace_megakernel(
        *trace_args, **phased, block_fn=mb.trace_block_torch), 2)
    print(f"phase 4 phased launch {kw['phase_depths']} B={B}: {'ok' if ph_ok else 'FAIL'} "
          f"mean_abs_err {err:.3g} segments {int(seg_k)} plain {int(seg_p)} "
          f"kernel {ph_ms:.3f} ms plain {ph_plain_ms:.3f} ms [{card}]")
    if not ph_ok:
        failures.append("phase 4 phased launch")

    print(json.dumps({"kernels": [{
        "name": "K1 megakernel_block", "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel_block.cu",
        "replaces": "raytracing_tpu/ops/megakernel_block.py:155",
        "launches": k1_launches, "max_abs_err": stats["max_abs_err"],
        "mean_abs_err": stats["mean_abs_err"], "ms": ms, "plain_ms": plain_ms,
    }]}))
    if failures:
        print(f"chip_smoke: FAILED {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
