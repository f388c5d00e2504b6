"""Entry points of the port, the counterparts of ``__graft_entry__.py``:

* ``entry()`` → ``(forward, (scene, params))``: one differentiable forward
  render (``diff.gradients.render_once``, the wavefront integrator) of the
  flagship scene, bouncing_spheres at 96 px wide, 2 spp, depth 6, on the
  card unless ``device`` names another. ``forward(scene, params)`` returns
  the (H, W, 3) mean radiance with autograd.
* ``dryrun_multichip(n)`` (``__graft_entry__.py:32-140``): n ranks
  (``parallel.mesh.spawn``) on a dp×tp×sp mesh take one Adam step of the
  sharded render's MSE with the per-bounce gradient all-reduce, then run
  the megakernel under dp×sp, the per-range-BVH tp path and a 2-stage
  pipeline (not with gloo on the card: it has no send/recv of CUDA
  tensors, and says so).

The rank bodies live here, so that a spawned rank imports the package and
nothing else: ``_dryrun_rank``, ``sharded_modes`` (every parallel mode at
a test size, for the CPU tests) and ``card_modes`` (the sharded renders
``chip_smoke.py`` holds on the card).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .core.device import DEFAULT_DEVICE, resolve


def entry(device=DEFAULT_DEVICE, image_width: int = 96):
    from .diff.gradients import render_once
    from .models.scenes import build
    from .render.camera import CameraParams

    dev = resolve(device)
    scene, cfg = build("bouncing_spheres", device=dev, image_width=image_width,
                       samples_per_pixel=2, max_depth=6)
    params = CameraParams.from_config(cfg, dev)

    def forward(scene_arg, params_arg):
        return render_once(scene_arg, cfg, params_arg, seed=0)

    return forward, (scene, params)


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> dict:
    """Spawn ``n_devices`` ranks on ``device`` (NCCL with a card a rank
    when there are enough cards, else gloo: ``parallel.mesh.default_backend``)
    and run :func:`_dryrun_rank` on each; prints and returns rank 0's
    summary. Raises if any rank fails."""
    from .parallel.mesh import default_backend, spawn

    backend = default_backend(resolve(device), n_devices)
    out = spawn(_dryrun_rank, n_devices, backend=backend, device=device)[0]
    print(f"dryrun_multichip OK: mesh dp={out['dp']} tp={out['tp']} sp={out['sp']}, "
          f"loss={out['loss']:.6f}, update_norm={out['update_norm']:.3e}, "
          f"mega+dp/sp OK (segments={out['mega_segments']})"
          + (f", tp-BVH OK (segments={out['bvh_segments']})" if out["tp"] > 1 else "")
          + (f", pp OK (segments={out['pp_segments']})" if "pp_segments" in out
             else ", pp not run (gloo has no send/recv of CUDA tensors)" if n_devices >= 2
             else ""))
    return out


def _dryrun_rank(device) -> dict:
    """The body of :func:`dryrun_multichip` on one rank of the process
    group: every check raises on failure."""
    import torch.distributed as dist

    from .models.scenes import build
    from .parallel.mesh import make_mesh
    from .parallel.pp import build_pp_renderer
    from .parallel.shard import build_sharded_renderer
    from .render.camera import CameraParams

    n = dist.get_world_size()
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % 4 == 0 else 1
    dp = n // (tp * sp)
    mesh = make_mesh((dp, tp, sp), ("dp", "tp", "sp"), device=device)
    scene, cfg = build("three_spheres", device=mesh.device, image_width=16,
                       samples_per_pixel=2, max_depth=3)
    render_fn, scene_prep, n_pix_pad = build_sharded_renderer(
        scene, cfg, mesh, grad_psum_axes=("dp", "sp"))
    cam0 = CameraParams.from_config(cfg, mesh.device)
    p0 = {"center": scene_prep.spheres.center, "rgb": scene_prep.textures.rgb,
          "lookfrom": cam0.lookfrom}
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    opt = torch.optim.Adam(list(p.values()), lr=1e-2)
    s = dataclasses.replace(
        scene_prep, spheres=dataclasses.replace(scene_prep.spheres, center=p["center"]),
        textures=dataclasses.replace(scene_prep.textures, rgb=p["rgb"]))
    part, _ = render_fn(s, dataclasses.replace(cam0, lookfrom=p["lookfrom"]), 0)
    loss = torch.mean((part / cfg.samples_per_pixel) ** 2)  # against a black target
    opt.zero_grad()
    loss.backward()
    opt.step()
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("non-finite loss in dryrun")
    gnorm = float(torch.sqrt(sum(torch.sum((p[k].detach() - p0[k]) ** 2) for k in p)))
    if not gnorm > 0:
        raise RuntimeError("training step produced no update")

    # the megakernel under the dp×sp mesh
    mesh2 = make_mesh((n // sp, sp), ("dp", "sp"), device=device)
    mega_fn, mega_scene, _ = build_sharded_renderer(scene, cfg, mesh2, hit_method="mega")
    with torch.no_grad():
        mpart, mseg = mega_fn(mega_scene, cam0, 0)
    if not (mseg > 0 and bool(torch.isfinite(mpart).all())):
        raise RuntimeError("sharded megakernel dryrun produced no or invalid radiance")
    out = dict(dp=dp, tp=tp, sp=sp, loss=float(loss.detach()), update_norm=gnorm,
               mega_segments=mseg)

    # each tp range walks its own BVH
    if tp > 1:
        bscene, bcfg = build("bouncing_spheres", device=mesh.device, image_width=16,
                             samples_per_pixel=1, max_depth=2)
        bvh_fn, bvh_scene, _ = build_sharded_renderer(bscene, bcfg, mesh, hit_method="bvh")
        with torch.no_grad():
            bpart, bseg = bvh_fn(bvh_scene, CameraParams.from_config(bcfg, mesh.device), 0)
        if not (bseg > 0 and bool(torch.isfinite(bpart).all())):
            raise RuntimeError("per-range-BVH tp dryrun produced no or invalid radiance")
        out["bvh_segments"] = bseg

    # a 2-stage pipeline on the first two ranks; its send/recv needs NCCL on
    # the card (gloo sends CPU tensors only)
    if n >= 2 and (mesh.device.type == "cpu" or dist.get_backend() == "nccl"):
        pmesh = make_mesh((2,), ("pp",), device=device)
        if pmesh.member:
            pp_fn, _, _ = build_pp_renderer(scene, cfg, pmesh)
            prad, pseg = pp_fn(scene, cam0, 0)
            if not (pseg > 0 and bool(torch.isfinite(prad).all())):
                raise RuntimeError("pp dryrun produced no or invalid radiance")
            out["pp_segments"] = pseg
    return out


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def sharded_modes(device, workdir: str) -> dict:
    """Every parallel mode of the port on 4 ranks at the size of the JAX
    package's parallel tests (three_spheres, 16 px, 4 spp, depth 3, seed
    5): images, segments and gradients for ``tests/test_torch_parallel.py``
    to compare with single-device renders. ``workdir`` holds the
    checkpoints."""
    import torch.distributed as dist

    from .models.scenes import build
    from .parallel.mesh import make_mesh
    from .parallel.multihost import render_sharded_distributed
    from .parallel.pp import build_pp_renderer
    from .parallel.shard import build_sharded_renderer, render_sharded
    from .render.camera import CameraParams

    if dist.get_world_size() != 4:
        raise ValueError("sharded_modes runs on 4 ranks")
    scene, cfg = build("three_spheres", device=device, image_width=16, samples_per_pixel=4,
                       max_depth=3)
    out = {}
    dp4 = make_mesh((4,), ("dp",), device=device)
    dpsp = make_mesh((2, 2), ("dp", "sp"), device=device)
    dptp = make_mesh((2, 2), ("dp", "tp"), device=device)
    out["dp4"] = render_sharded(scene, cfg, dp4, seed=5)
    out["dp2sp2"] = render_sharded(scene, cfg, dpsp, seed=5)
    for method in ("brute", "ring", "bvh"):
        out[f"dp2tp2_{method}"] = render_sharded(scene, cfg, dptp, seed=5, hit_method=method)
    out["dp4_mega"] = render_sharded(scene, cfg, dp4, seed=5, hit_method="mega")

    # bounce pipelines (tests/test_pp.py): 2 stages on a dp2×pp2 mesh (both
    # dp rows run the same pipe), 4 stages, and an emissive scene
    pp_meshes = {2: make_mesh((2, 2), ("dp", "pp"), device=device),
                 4: make_mesh((4,), ("pp",), device=device)}
    for n_stages, name, width, spp, depth in ((2, "three_spheres", 16, 4, 6),
                                              (4, "three_spheres", 16, 4, 7),
                                              (2, "simple_light", 16, 2, 5)):
        s, c = build(name, device=device, image_width=width, samples_per_pixel=spp,
                     max_depth=depth)
        fn, n_rays_pad, n_micro = build_pp_renderer(s, c, pp_meshes[n_stages])
        rad, segs = fn(s, CameraParams.from_config(c, device), 5)
        out[f"pp{n_stages}_{name}_d{depth}"] = (_np(rad), segs, n_micro)

    # gradients through the sharded render: plain, and with the per-bounce
    # all-reduce (tests/test_parallel.py TestShardedGradients)
    cam = CameraParams.from_config(cfg, device)

    def rgb_grad(mesh, axes=()):
        fn, prep, _ = build_sharded_renderer(scene, cfg, mesh, grad_psum_axes=axes)
        rgb = prep.textures.rgb.detach().clone().requires_grad_(True)
        s = dataclasses.replace(prep, textures=dataclasses.replace(prep.textures, rgb=rgb))
        part, _ = fn(s, cam, 0)
        loss = torch.mean(part[:cfg.n_pixels] / cfg.samples_per_pixel)
        return _np(torch.autograd.grad(loss, rgb)[0])

    out["grad_plain"] = rgb_grad(dpsp)
    out["grad_overlap"] = rgb_grad(dpsp, ("dp", "sp"))
    dptpsp = make_mesh((1, 2, 2), ("dp", "tp", "sp"), device=device)
    out["grad_dp1tp2sp2"] = rgb_grad(dptpsp)

    # windows with a checkpoint: uninterrupted, then stopped after window 0
    # on every rank and resumed
    ck = os.path.join(workdir, "ck.npz")
    whole = render_sharded_distributed(scene, cfg, dpsp, seed=5, sample_chunk=2)

    class _Stop(Exception):
        pass

    def stop_after_first(k):
        if k == 0:
            raise _Stop

    try:
        render_sharded_distributed(scene, cfg, dpsp, seed=5, sample_chunk=2, checkpoint=ck,
                                   chunk_cb=stop_after_first)
    except _Stop:
        pass
    with np.load(ck) as f:
        next_window = int(f["next_window"])
    seen = []
    resumed = render_sharded_distributed(scene, cfg, dpsp, seed=5, sample_chunk=2,
                                         checkpoint=ck, chunk_cb=seen.append)
    out["windows"] = dict(whole=whole, resumed=resumed, next_window=next_window,
                          resumed_windows=seen)
    out["dryrun"] = _dryrun_rank(device)
    return out


def render_rank(device, scene_name: str, overrides: dict, seed: int, hit_method: str):
    """The CLI's ``--devices`` body on one rank: the registry scene on a dp
    mesh of every rank → ((H, W, 3) mean radiance, segments)."""
    from .models.scenes import build
    from .parallel.mesh import make_mesh
    from .parallel.shard import render_sharded

    mesh = make_mesh(device=device)
    scene, cfg = build(scene_name, device=mesh.device, **overrides)
    return render_sharded(scene, cfg, mesh, seed=seed, hit_method=hit_method)


def card_modes(device, spec: dict) -> dict:
    """The sharded renders ``chip_smoke.py`` holds on the card, on this
    rank: for every entry of ``spec`` (name → dict(mesh=(sizes, names),
    scene, width, spp, depth, hit)) the render's image and segments, its
    wall (after one warm-up) and this rank's kernel launches (K1, K5 and
    the BVH walk) in the timed render."""
    import time

    from .models.scenes import build
    from .ops import megakernel_block as mb
    from .ops import megakernel_group as mg
    from .ops import traverse
    from .parallel.mesh import barrier, make_mesh
    from .parallel.shard import render_sharded

    out = {}
    meshes = {}
    for name, c in spec.items():
        key = tuple(map(tuple, c["mesh"]))
        if key not in meshes:
            meshes[key] = make_mesh(*c["mesh"], device=device)
        mesh = meshes[key]
        scene, cfg = build(c["scene"], device=mesh.device, image_width=c["width"],
                           samples_per_pixel=c["spp"], max_depth=c["depth"])
        render_sharded(scene, cfg, mesh, seed=c.get("seed", 7), hit_method=c["hit"])
        barrier(mesh)
        for count in (mb.launches, mg.launches, traverse.launches):
            count.reset()
        t0 = time.perf_counter()
        img, segs = render_sharded(scene, cfg, mesh, seed=c.get("seed", 7), hit_method=c["hit"])
        wall = time.perf_counter() - t0
        out[name] = dict(img=img, segments=segs, seconds=wall, K1=int(mb.launches),
                         K5=int(mg.launches), walk=int(traverse.launches), rank=mesh.rank)
    return out
