"""K4 (the table gather), the table fold and K3 (the replay forward) on the
bench's chunk, checksummed, for one checkout; run a parent beside it in turns.

    python3 tools/time_k3k4.py [--root DIR] [--reps N] [--probe]

Imports raytracing_tpu_torch from DIR (default: this checkout), so a parent
commit unpacked beside it can be timed in the same call, in turns (one
process per checkout: parent, change, change, parent). Prints the card's
name and power limit first, then one JSON line per measurement, each with
the device ms (CUDA events, mean over ``--reps`` launches after a warm-up,
queued behind a spin kernel so the wrappers' host time is hidden):

* K4 (``table_gather.gather``) on one bounce's recorded ids of a fwd+bwd
  chunk (bouncing_spheres 400x225, 100 spp, depth 20: B = 360,448,
  L = 512) and on numpy-seeded ids over the bouncing_spheres_64 replay
  table (L = 4,224), with a checksum of the output (equal checksums from
  two checkouts: the same bytes);
* the lookup's backward on the same ids and a numpy-seeded cotangent (the
  fold where the checkout has it, else ``index_add_``), with its largest
  error against a float64 sum;
* the chunk's table reduction (``replay_kernel.reduce_table_grads``) over
  the planned prefixes, with its error against a float64 sum: the device
  time of its sum (the fold's one launch, or the ``index_add_`` calls) and
  the whole call's (host included, back to back);
* K3 (``replay_kernel.replay_fwd``) on the chunk's rays sorted by recorded
  length with the tiles' recorded maxima (phase 5 of chip_smoke.py), and
  on the same rays in camera order with every tile at depth 20 (what
  ``replay_trace_kernel`` runs without ``lengths``), and K2 on the sorted
  rays, each with a checksum of its outputs;
* K2 on the same chunk traced and sorted at depth 50 (BASELINE config
  5's; the decision pass's phases ``[2, 2, 3, 4, 39]``), with a checksum
  of its output.

``--probe`` (a checkout that has ``replay_fwd_probe``) then runs K3's two
designs (``replay_kernel.K3_DESIGNS``: one thread per ray, and lanes that
refill) on both K3 inputs in turns, with their checksums, and their
counting instantiation: bounces run (which must equal the plain version's
segments) and the share of a warp's lanes busy at a bounce.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SEED = 7
K2_DEPTH = 50  # K2's second depth: BASELINE config 5's


def checksum(*tensors) -> str:
    """sha256 (16 hex digits) of the tensors' bytes."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def chunk_inputs(pkg, rk, rf, mk, cam, dev, depth=20):
    """The fwd+bwd chunk (spp_chunk 4, B = 360,448) of the bench workload
    at ``depth``: a K1 decision pass with ids and counts, its rays sorted by
    recorded length as replay_grads_sorted sorts them, and a numpy-seeded
    radiance cotangent. Returns (sorted inputs, camera-order inputs, kw,
    lengths)."""
    scene, cfg = pkg.build("bouncing_spheres", device=dev, image_width=400,
                           samples_per_pixel=100, max_depth=depth)
    D, spp_chunk, n_pix = cfg.max_depth, 4, cfg.n_pixels
    npix_pad = -(-n_pix // 1024) * 1024
    n = npix_pad * spp_chunk
    pix = torch.clamp(torch.arange(npix_pad, device=dev), max=n_pix - 1).repeat(spp_chunk)
    smp = torch.arange(spp_chunk, device=dev).repeat_interleave(npix_pad)
    act = (torch.arange(npix_pad, device=dev) < n_pix).repeat(spp_chunk)
    der = cam.derive(cfg, cam.CameraParams.from_config(cfg, dev))
    o, d, t = cam.generate_rays(cfg, der, pix, smp, SEED, motion_blur=scene.flags.has_moving)
    _, _, ids, cnt = mk.trace_megakernel(
        mk.build_mega_scene(scene), o, d, t, pix, smp, cfg.background, D, SEED,
        phase_depths=[2, 2, 3, 4, D - 11], active0=act, want_ids=True, want_counts=True)
    table = rf.build_replay_table(scene).detach()
    rad_bar = torch.from_numpy(np.random.default_rng(3).normal(size=(3, n)).astype(
        np.float32)).to(dev)
    kw = dict(seed=SEED, n_sph=scene.n_spheres, has_moving=scene.flags.has_moving,
              background=cfg.background)
    order = torch.argsort((D - cnt.long()) * n + torch.arange(n, device=dev))
    len_s = cnt[order]
    ray_i = torch.stack([pix, smp]).to(torch.int32)
    sorted_ = (table, ids[:, order].contiguous(),
               rk.pack_replay_rays(o[order], d[order], t[order], len_s > 0),
               ray_i[:, order].contiguous(), rk.tile_maxlen(len_s, D), rad_bar)
    camera = (table, ids.contiguous(), rk.pack_replay_rays(o, d, t, act), ray_i,
              torch.full((n // 1024,), D, dtype=torch.int32, device=dev), rad_bar)
    return sorted_, camera, kw, len_s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    # this checkout's chip_smoke (its device_ms), the package of --root
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    smoke = importlib.import_module("chip_smoke")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    pkg = importlib.import_module("raytracing_tpu_torch")
    rk = importlib.import_module("raytracing_tpu_torch.diff.replay_kernel")
    rf = importlib.import_module("raytracing_tpu_torch.diff.replay_fast")
    tg = importlib.import_module("raytracing_tpu_torch.ops.table_gather")
    mk = importlib.import_module("raytracing_tpu_torch.ops.megakernel")
    cam = importlib.import_module("raytracing_tpu_torch.render.camera")
    kernels = importlib.import_module("raytracing_tpu_torch._kernels")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"time_k3k4: {pkg.__file__} [{card}]", flush=True)
    kernels.library()
    has_fold = hasattr(tg, "fold")

    def line(**kw):
        print(json.dumps(dict(kw, card=card)), flush=True)

    def ms(fn):
        return smoke.device_ms(torch, fn, args.reps)

    sorted_, camera, kw, len_s = chunk_inputs(pkg, rk, rf, mk, cam, dev)
    table, ids_s = sorted_[0], sorted_[1]
    n, D = ids_s.shape[1], ids_s.shape[0]
    s64, _ = smoke.bouncing_spheres_64(dev)
    table64 = rf.build_replay_table(s64).detach()
    ids64 = torch.from_numpy(np.random.default_rng(5).integers(
        -1, table64.shape[0], n).astype(np.int32)).to(dev)

    # K4 and the lookup's backward
    for name, tab, idv in (("bench chunk bounce 1", table, ids_s[1].contiguous()),
                           ("bouncing_spheres_64 table", table64, ids64)):
        L, F = tab.shape
        out = tg.gather(tab, idv)
        g = torch.from_numpy(np.random.default_rng(4).normal(size=(F, n)).astype(
            np.float32)).to(dev)
        g[:, idv < 0] = 0.0  # a miss's cotangent is zero, as replay_fast's masks make it

        def backward():
            if has_fold:
                return tg.fold(g, idv, L)
            tbar = torch.zeros((L, F), dtype=torch.float32, device=dev)
            return tbar.index_add_(0, idv.clamp(0, L - 1).long(), g.t())

        exact = torch.zeros((L, F), dtype=torch.float64, device=dev).index_add_(
            0, idv.clamp(0, L - 1).long(), g.t().double())
        line(kernel="K4", case=name, L=L, F=F, B=n, checksum=checksum(out),
             ms=ms(lambda: tg.gather(tab, idv)))
        line(kernel="fold" if has_fold else "index_add_", case=name, L=L, F=F, B=n,
             max_abs_err_vs_float64=float((backward().double() - exact).abs().max()),
             ms=ms(backward))

    # the chunk's table reduction over the planned prefixes
    g2 = rk.replay_bwd(*sorted_[:4], sorted_[5], sorted_[4], **kw)
    prefixes = rk.plan_prefixes(torch.bincount(len_s.long(), minlength=D + 1).cpu(), n, D,
                                margin=1.0)
    L = table.shape[0]
    exact = torch.zeros((L, rk.NG), dtype=torch.float64, device=dev)
    for b, P in enumerate(prefixes):
        exact.index_add_(0, ids_s[b, :P].clamp(min=0).long(), g2[b, :, :P].T.double())
    red = rk.reduce_table_grads(g2, ids_s, L, prefixes)
    line(kernel="reduction", via="fold" if has_fold else "index_add_", prefixes=list(prefixes),
         rays=int(sum(prefixes)), max_abs_err_vs_float64=float(
             (red[:, rk._TCOLS].double() - exact[:, rk._GSLOTS]).abs().max()),
         ms=ms(lambda: tg.fold(g2, ids_s, L, prefixes)) if has_fold else ms(
             lambda: rk.reduce_table_grads(g2, ids_s, L, prefixes)),
         ms_reduce_table_grads=smoke.cuda_ms(
             torch, lambda: rk.reduce_table_grads(g2, ids_s, L, prefixes), args.reps))
    del g2

    # K3 and K2
    k3_inputs = {"sorted, tile maxima": sorted_, "camera order, depth 20": camera}
    for name, (tab, ids, ray_f, ray_i, maxlen, _) in k3_inputs.items():
        rad, bc = rk.replay_fwd(tab, ids, ray_f, ray_i, maxlen, **kw)
        line(kernel="K3", case=name, B=n, segments=int(bc.sum()), checksum=checksum(rad, bc),
             ms=ms(lambda: rk.replay_fwd(tab, ids, ray_f, ray_i, maxlen, **kw)))
    tab, ids, ray_f, ray_i, maxlen, rad_bar = sorted_
    g2 = rk.replay_bwd(tab, ids, ray_f, ray_i, rad_bar, maxlen, **kw)
    line(kernel="K2", case="sorted, tile maxima", B=n, D=D, checksum=checksum(g2), ms=ms(
        lambda: rk.replay_bwd(tab, ids, ray_f, ray_i, rad_bar, maxlen, **kw)))
    del g2
    (tab, ids, ray_f, ray_i, maxlen, rad_bar), _, kw50, len50 = chunk_inputs(
        pkg, rk, rf, mk, cam, dev, K2_DEPTH)
    g2 = rk.replay_bwd(tab, ids, ray_f, ray_i, rad_bar, maxlen, **kw50)
    line(kernel="K2", case="sorted, tile maxima", B=n, D=K2_DEPTH, longest=int(len50.max()),
         checksum=checksum(g2), ms=ms(
             lambda: rk.replay_bwd(tab, ids, ray_f, ray_i, rad_bar, maxlen, **kw50)))
    del g2

    if not args.probe:
        return 0
    probes = [(name, design) for name in k3_inputs for design in rk.K3_DESIGNS]
    times = {p: [] for p in probes}
    sums = {}
    for p in probes + probes[::-1]:  # in turns: each probe twice, mirrored
        name, design = p
        tab, ids, ray_f, ray_i, maxlen, _ = k3_inputs[name]

        def run():
            return rk.replay_fwd_probe(tab, ids, ray_f, ray_i, maxlen, design=design, **kw)

        rad, bc, _ = run()
        sums[p] = checksum(rad, bc)
        times[p].append(ms(run))
    for p in probes:
        name, design = p
        tab, ids, ray_f, ray_i, maxlen, _ = k3_inputs[name]
        _, bc, c = rk.replay_fwd_probe(tab, ids, ray_f, ray_i, maxlen, design=design,
                                       count=True, **kw)
        _, bc_plain = rk.replay_fwd_torch(tab, ids, ray_f, ray_i, maxlen, **kw)
        line(kernel="K3 probe", case=name, design=design, checksum=sums[p], ms=times[p],
             segments=int(bc.sum()), segments_plain=int(bc_plain.sum()), **c,
             lane_share=c["bounces"] / (32 * c["issues"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
