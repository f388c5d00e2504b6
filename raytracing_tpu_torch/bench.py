"""Benchmark of the port on the card: traced segments per second of the
forward render and of the forward+backward gradient sweep, on the bench
workload (bouncing_spheres, 400×225, 100 spp, depth 20, seed 7).

    python -m raytracing_tpu_torch.bench [--devices N]

prints one JSON line in the JAX package's bench schema (``bench.py`` at
the repository root) with ``"backend": "cuda"``:

    {"metric": "rays_per_s_fwd_final_scene", "value": N, "unit": "rays/s",
     "vs_baseline": N / 5e8, "method": "mega", "segments": S,
     "seconds": T, "backend": "cuda", "device": "<card>",
     "rays_per_s_fwd_bwd": N2, "fwd_bwd_segments": S2,
     "fwd_bwd_seconds": T2}

"Rays" are ray-scene queries actually traced (path segments), counted
exactly by the kernels. It needs a CUDA device and raises without one (or
on any failure); the functions take ``device="cpu"`` to run the plain
versions at small sizes. ``--devices N`` prints the dp weak-scaling line
instead (:func:`bench_scaling`).
"""
from __future__ import annotations

import dataclasses
import json
import time

import torch

from .core.device import DEFAULT_DEVICE, resolve
from .diff.replay_fast import build_replay_table, supported_fast
from .diff.replay_kernel import TILE, plan_prefixes, replay_grads_sorted, replay_rays
from .models.scenes import build
from .ops.megakernel import BLOCK, build_mega_scene, trace_megakernel
from .render import camera as cam_mod
from .render import graphs
from .render.renderer import Renderer, rays_past
from .utils.profiling import annotate, stage

BASELINE_RAYS_PER_S = 5e8


def bench_forward(width=400, spp=100, max_depth=20, seed=7, device=DEFAULT_DEVICE, reps=3):
    """Best of ``reps`` renders (after one warm-up) through the phased
    megakernel schedule [2,2,3,4,d-11] with planned prefixes."""
    scene, cfg = build("bouncing_spheres", device=device, image_width=width,
                       samples_per_pixel=spp, max_depth=max_depth)
    kw = dict(hit_method="mega", max_rays_per_launch=1 << 18, transfer="u8")
    if max_depth >= 12:
        kw["phase_depths"] = [2, 2, 3, 4, max_depth - 11]
    r = Renderer(cfg, **kw)
    pref = r.plan_phase_prefixes(scene, seed=seed)
    if pref is not None:
        r = Renderer(cfg, **kw, phase_prefixes=pref)
    r.render(scene, seed=seed)  # warm-up: the kernels' build, allocator, libraries
    res = min((r.render(scene, seed=seed) for _ in range(reps)), key=lambda x: x.seconds)
    return dict(method="mega", rays_per_s=res.segments / res.seconds, segments=res.segments,
                seconds=res.seconds)


def _fwd_bwd_setup(width=400, spp=100, max_depth=20, seed=7, spp_chunk=4, phases="default",
                   device=DEFAULT_DEVICE, cull=None):
    """The fwd+bwd chunk machinery, as the JAX bench's ``_fwd_bwd_setup``.

    Each chunk (``spp_chunk`` samples of every pixel, B rays) runs the
    decision pass (K1 with ``want_ids="compacted"``, ``want_counts``),
    the MSE loss against a black target and its analytic per-ray radiance
    cotangent, ``replay_grads_sorted`` (length sort, K2, the table
    reduction over planned prefixes) and the VJP of
    ``build_replay_table`` to sphere centers and texture rgbs.

    Returns a dict: ``grads_chunk(center, rgb, sample0) -> (loss, g_center,
    g_rgb, ok, segments)`` (``sample0`` an int or a 0-d int64 tensor on
    the device), ``plan(fused=True)`` (the untimed planning sweep that
    installs the per-bounce prefixes and the decision pass's phase
    prefixes into ``ns``), ``sweep(fused=True)`` (every chunk, summed:
    ``(loss, g_center, g_rgb, segments, ok)``), ``args``, ``n_chunks``,
    ``spp_chunk``, ``B``, ``ns``, ``device`` and ``programs``. ``cull``
    forces K1's search in the decision pass (``trace_megakernel``).

    ``fused``, as in the JAX bench: the sweep (or the plan) is one chunk
    program (``render/graphs.py``) replayed once a chunk, a CUDA graph on
    a card, the chunk's first sample read from a device counter and its
    results added into static accumulators; ``fused=False`` issues every
    chunk from Python. Both give the same loss, segments and ``ok`` and,
    on the CPU, the same gradients bit for bit (on a card the fold adds
    in a run-dependent order). ``programs`` keeps the last program (its
    graph and ``capture_seconds``); a sweep after a new plan captures
    anew.

    With the port's tracing switch on (``utils.profiling``) a sweep is the
    span ``rt.sweep`` (its chunks ``rt.sweep.replay``, its sums' copies
    ``rt.sweep.finish``), a plan ``rt.plan``, and a chunk's stages are
    ``camera``, the decision pass's own, ``loss``, ``vjp`` (the table's
    build), the replay's (``sort``, ``camera``, ``k2``, ``fold``), ``vjp``
    (autograd) and ``accumulate``."""
    dev = resolve(device)
    scene, cfg = build("bouncing_spheres", device=dev, image_width=width,
                       samples_per_pixel=spp, max_depth=max_depth)
    if not supported_fast(scene):
        raise ValueError("the bench workload must be replayable (solid and checker textures)")
    if spp % spp_chunk:
        raise ValueError(f"spp={spp} must divide by spp_chunk={spp_chunk}")
    mega = build_mega_scene(scene)
    n_pix = cfg.n_pixels
    npix_pad = -(-n_pix // BLOCK) * BLOCK
    B = npix_pad * spp_chunk
    assert B % TILE == 0
    target = torch.zeros((cfg.image_height, cfg.image_width, 3), dtype=torch.float32, device=dev)
    pix = torch.clamp(torch.arange(npix_pad, device=dev), max=n_pix - 1).repeat(spp_chunk)
    act0 = (torch.arange(npix_pad, device=dev) < n_pix).repeat(spp_chunk)
    # the camera on the device: K1's first phase and the replay's rays
    # compute each ray from it where they use it
    derived = cam_mod.derive(cfg, cam_mod.CameraParams.from_config(cfg, dev))
    camera = cam_mod.CameraStart.of(cfg, cam_mod.pack_camera(derived), scene.flags.has_moving)
    if phases == "default":
        if max_depth >= 12:
            phases = [2, 2, 3, 4, max_depth - 11]
        elif max_depth >= 8:
            phases = [2, 3, max_depth - 5]
        else:
            phases = None
    n_chunks = spp // spp_chunk
    ns = {"prefixes": None,          # replay per-bounce prefixes
          "decide_prefixes": None}   # decision pass per-phase prefixes

    def decide(sample0):
        with stage("camera", dev):
            smp = sample0 + torch.arange(spp_chunk, device=dev).repeat_interleave(npix_pad)
        out = trace_megakernel(mega, None, None, None, pix, smp, cfg.background, max_depth, seed,
                               phase_depths=phases, active0=act0, want_ids="compacted",
                               want_counts=True, phase_prefixes=ns["decide_prefixes"],
                               cull=cull, camera=camera)
        rad, _, ids0, later, perm, cnt, cnt_c, *ok = out
        bundle = dict(ids0=ids0, later=later, perm=perm, counts_c=cnt_c,
                      phase_depths=tuple(phases) if phases is not None else (max_depth,))
        ok = ok[0] if ok else torch.ones((), dtype=torch.bool, device=dev)
        return rad, bundle, cnt, ok

    programs = graphs.ProgramSlot()

    def over_chunks(kind, make_state, step, fused):
        """``step(c, state)`` for every chunk ``c``: a loop, or with
        ``fused`` the replayed program of ``kind`` for the installed
        prefixes (``graphs.over_chunks``). Returns the state."""
        key = (kind, ns["prefixes"], ns["decide_prefixes"])
        return graphs.over_chunks(programs, key, make_state, step, 0, n_chunks, dev, fused)[0]

    def plan_step(c, st):
        cnt = decide(c * spp_chunk)[2]
        with stage("accumulate", dev):
            torch.maximum(st["nb_max"], rays_past(cnt, max_depth), out=st["nb_max"])

    def plan(fused=True):
        """The untimed planning sweep: per-bounce live-ray maxima over the
        chunks (bounce b touches the rays with recorded length > b)."""
        with annotate("rt.plan"):
            nb_max = over_chunks("plan", lambda: dict(nb_max=torch.zeros(
                max_depth + 1, dtype=torch.int64, device=dev)), plan_step, fused)["nb_max"]
            nb = nb_max.cpu().tolist()
            # the length histogram whose suffix sums are those maxima
            hist = [nb[k] - (nb[k + 1] if k < max_depth else 0) for k in range(max_depth + 1)]
            ns["prefixes"] = plan_prefixes(hist, B, max_depth, margin=1.0)
            if phases is not None:
                # the phase starting after s bounces touches only the rays alive then
                starts = [0]
                for pdep in phases[:-1]:
                    starts.append(starts[-1] + pdep)
                ns["decide_prefixes"] = tuple(
                    [None] + [max(BLOCK, min(B, -(-nb[min(s + 1, max_depth)] // BLOCK) * BLOCK))
                              for s in starts[1:]])
            return ns["prefixes"]

    def grads_chunk(center, rgb, sample0):
        rad_pre, bundle, cnt, ok_d = decide(sample0)
        with stage("loss", dev):
            img = (rad_pre * act0[:, None]).reshape(spp_chunk, npix_pad, 3).mean(dim=0)
            img = img[:n_pix].reshape(cfg.image_height, cfg.image_width, 3)
            loss = torch.mean((img - target) ** 2)
            # analytic per-ray radiance cotangent: the rays of pixel p share
            # dL/dimg[p] / spp_chunk; padding rays contribute nothing
            gimg = (2.0 / (n_pix * 3)) * (img - target)
            gpad = torch.cat([gimg.reshape(n_pix, 3),
                              torch.zeros((npix_pad - n_pix, 3), dtype=torch.float32,
                                          device=dev)])
            rad_bar = gpad.repeat(spp_chunk, 1) * act0[:, None] / spp_chunk

        def ray_regen(orig, alive):
            # camera rays are pure functions of the original ray index
            p = torch.clamp(orig % npix_pad, max=n_pix - 1)
            s = sample0 + torch.div(orig, npix_pad, rounding_mode="floor")
            ray_i = torch.stack([p, s]).to(torch.int32)
            return replay_rays(camera, ray_i, alive, seed), ray_i

        with stage("vjp", dev):
            c = center.detach().requires_grad_(True)
            r = rgb.detach().requires_grad_(True)
            table = build_replay_table(dataclasses.replace(
                scene, spheres=dataclasses.replace(scene.spheres, center=c),
                textures=dataclasses.replace(scene.textures, rgb=r)))
        tbar, ok = replay_grads_sorted(scene, table, cfg.background, max_depth, seed, rad_bar,
                                       cnt, prefixes=ns["prefixes"], ray_regen=ray_regen,
                                       compacted=bundle)
        with stage("vjp", dev):
            gc, gr = torch.autograd.grad(table, (c, r), tbar)
        with stage("accumulate", dev):
            return loss.detach(), gc, gr, ok & ok_d, cnt.to(torch.int64).sum()

    args = (scene.spheres.center, scene.textures.rgb)

    def sums():
        return dict(loss=torch.zeros((), dtype=torch.float32, device=dev),
                    gc=torch.zeros_like(args[0]), gr=torch.zeros_like(args[1]),
                    segs=torch.zeros((), dtype=torch.int64, device=dev),
                    ok=torch.ones((), dtype=torch.bool, device=dev))

    def sweep_step(c, st):
        loss, g1, g2, ok_c, seg = grads_chunk(*args, c * spp_chunk)
        with stage("accumulate", dev):
            st["loss"].add_(loss)
            st["gc"].add_(g1)
            st["gr"].add_(g2)
            st["segs"].add_(seg)
            st["ok"].logical_and_(ok_c)

    def sweep(fused=True):
        with annotate("rt.sweep"):
            with annotate("rt.sweep.replay"):
                st = over_chunks("sweep", sums, sweep_step, fused)
            with annotate("rt.sweep.finish"):
                return tuple(st[k].clone() for k in ("loss", "gc", "gr", "segs", "ok"))

    return dict(grads_chunk=grads_chunk, plan=plan, sweep=sweep, args=args, n_chunks=n_chunks,
                spp_chunk=spp_chunk, B=B, ns=ns, device=dev, programs=programs)


def bench_fwd_bwd(width=400, spp=100, max_depth=20, seed=7, spp_chunk=4, phases="default",
                  device=DEFAULT_DEVICE, reps=3, fused=True):
    """Forward+backward throughput: the planning sweep (untimed), one
    warm-up sweep, then :func:`time_fwd_bwd` over ``reps`` sweeps, each
    one replayed chunk program with ``fused`` (the JAX bench's single
    dispatch), else a chunk loop."""
    s = _fwd_bwd_setup(width=width, spp=spp, max_depth=max_depth, seed=seed,
                       spp_chunk=spp_chunk, phases=phases, device=device)
    s["plan"](fused=fused)
    s["sweep"](fused=fused)
    return dict(time_fwd_bwd(s, reps, fused=fused), fused=fused)


def time_fwd_bwd(s, reps=3, fused=True):
    """The best of ``reps`` timed sweeps of a planned ``_fwd_bwd_setup``
    over every chunk (``sweep(fused=fused)``): loss value and gradients
    with respect to sphere centers and texture rgbs, read to the host in
    one copy inside the timed region. Each timed sweep must keep its plan
    (``ok``), else this raises: the gradients would be incomplete.
    Segments are the decision pass's exact count, each counted once.
    Returns ``seconds``, ``segments``, ``rays_per_s``, ``loss``,
    ``grads_finite`` and the best sweep's ``grad_center`` and
    ``grad_rgb`` (host tensors)."""
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        lo, gc, gr, segs, ok = graphs.to_host(*s["sweep"](fused=fused))
        dt = time.perf_counter() - t0
        if not ok:
            raise RuntimeError("replay prefix plan violated: gradients incomplete")
        if best is None or dt < best[0]:
            best = (dt, float(lo), int(segs), gc, gr)
    dt, loss, segments, gc, gr = best
    gc, gr = torch.from_numpy(gc), torch.from_numpy(gr)
    return dict(seconds=dt, segments=segments, rays_per_s=segments / dt, loss=loss,
                grads_finite=bool(torch.isfinite(gc).all() and torch.isfinite(gr).all()),
                grad_center=gc, grad_rgb=gr)


def bench_scaling(n_devices=8, width=200, spp=16, max_depth=8, seed=7, device=DEFAULT_DEVICE):
    """The dp weak-scaling line (``bench.py:518-603``): segments per second
    of the sharded render (``hit_method="bvh"``) on a dp mesh of
    ``n_devices`` ranks against one (``scaling.rate``). ``efficiency`` =
    rate_N / (N · rate_1) where every rank has a card of its own, else null:
    ranks that share a card (gloo) cannot scale, and their rates are
    written down as such."""
    from . import scaling

    r1 = scaling.rate(1, width, spp, max_depth, seed, device=device)
    rn = scaling.rate(n_devices, width, spp, max_depth, seed, device=device)
    shared = rn["ranks_share_a_device"]
    return dict(devices=n_devices, rays_per_s_1dev=round(r1["rays_per_s"]),
                rays_per_s_ndev=round(rn["rays_per_s"]),
                efficiency=None if shared else round(rn["rays_per_s"] /
                                                     (n_devices * r1["rays_per_s"]), 4),
                backend=rn["backend"], ranks_share_a_device=shared,
                device=torch.cuda.get_device_name(0) if resolve(device).type == "cuda" else "cpu")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="raytracing_tpu_torch.bench")
    ap.add_argument("--devices", type=int, default=None,
                    help="the dp weak-scaling line on N ranks (bench_scaling)")
    args = ap.parse_args(argv)
    if args.devices is not None:
        print(json.dumps(dict(metric="scaling_efficiency_dp", unit="ratio",
                              **bench_scaling(args.devices))))
        return
    dev = resolve(DEFAULT_DEVICE)
    fwd = bench_forward(device=dev)
    bwd = bench_fwd_bwd(device=dev)
    print(json.dumps({
        "metric": "rays_per_s_fwd_final_scene",
        "value": round(fwd["rays_per_s"]),
        "unit": "rays/s",
        "vs_baseline": round(fwd["rays_per_s"] / BASELINE_RAYS_PER_S, 4),
        "method": fwd["method"],
        "segments": int(fwd["segments"]),
        "seconds": round(fwd["seconds"], 4),
        "backend": "cuda",
        "device": torch.cuda.get_device_name(dev),
        "rays_per_s_fwd_bwd": round(bwd["rays_per_s"]),
        "fwd_bwd_segments": int(bwd["segments"]),
        "fwd_bwd_seconds": round(bwd["seconds"], 3),
    }))


if __name__ == "__main__":
    main()
