"""The pool's banking step, timed two ways on one CUDA device.

    python3 tools/time_pool_fold.py [--reps 5]

The regenerating pool (``raytracing_tpu_torch/render/pool.py``) banks the
radiance of the paths that end in each iteration. The JAX package offers
two ways: ``sort`` appends (gid, r, g, b) rows to a death-order log that
one final sort by gid puts in stream order (TPU scatters are slow), and
``scatter`` writes each path's row at its gid (``index_copy_``, unique
indices). This script times both on the bench workload's stream
(bouncing_spheres 400x225, 100 spp: 9,000,000 paths): first one pool
render through ``Renderer(schedule="pool")``, for its wall time and its
number of iterations (K1 launches); then the banking step alone, the
stream's gids split in a random order into that many chunks, each chunk
sorted by gid as the pool's partition leaves it, and each row's radiance
read from a strided (N_F, P) ray-state slice as in the pool. The random
split scatters each chunk's rows over the whole stream, a harder case for
``index_copy_`` than the pool's mostly gid-ordered deaths. Times are CUDA
events over the whole step, both ways in turns (sort, scatter, scatter,
sort) ``--reps`` times. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from raytracing_tpu_torch import Renderer, _kernels, build  # noqa: E402
from raytracing_tpu_torch.ops import megakernel_block as mb  # noqa: E402

SEED = 7
P = 1 << 18


def bank_sort(chunks, state, total):
    log = torch.empty((total, 4), dtype=torch.float32, device=state.device)
    wp = 0
    for gid in chunks:
        n = gid.numel()
        log[wp:wp + n, 0] = gid.to(torch.float32)
        log[wp:wp + n, 1:] = state[mb.RR:mb.RB + 1, :n].T
        wp += n
    return log[torch.argsort(log[:, 0]), 1:]


def bank_scatter(chunks, state, total):
    acc = torch.empty((total, 3), dtype=torch.float32, device=state.device)
    for gid in chunks:
        acc.index_copy_(0, gid.long(), state[mb.RR:mb.RB + 1, :gid.numel()].T)
    return acc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    _kernels.library()
    scene, cfg = build("bouncing_spheres", device=dev, image_width=400,
                       samples_per_pixel=100, max_depth=20)
    r = Renderer(cfg, max_rays_per_launch=1 << 18, transfer="u8", schedule="pool")
    r.render(scene, seed=SEED)  # warm-up
    before = int(mb.launches)
    res = r.render(scene, seed=SEED)
    n_iter = int(mb.launches) - before
    print(f"pool render: {res.seconds:.4f} s, {n_iter} iterations, "
          f"{res.segments} segments")

    total = cfg.n_pixels * cfg.samples_per_pixel
    g = torch.Generator(device="cpu").manual_seed(SEED)
    order = torch.randperm(total, generator=g).to(dev, torch.int32)
    chunks = [c.sort().values for c in order.chunk(n_iter)]
    state = torch.rand((mb.N_F, P), generator=g).to(dev)
    want = bank_scatter(chunks, state, total)
    if not torch.equal(bank_sort(chunks, state, total), want):
        print("the two folds disagree", file=sys.stderr)
        return 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = {"sort": [], "scatter": []}
    fns = {"sort": bank_sort, "scatter": bank_scatter}
    for _ in range(args.reps):
        for name in ("sort", "scatter", "scatter", "sort"):
            torch.cuda.synchronize()
            start.record()
            fns[name](chunks, state, total)
            end.record()
            torch.cuda.synchronize()
            times[name].append(round(start.elapsed_time(end), 4))
    for name, ts in times.items():
        print(f"bank {name}: {total} rows in {n_iter} chunks, ms {ts} "
              f"(min {min(ts)}, median {sorted(ts)[len(ts) // 2]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
