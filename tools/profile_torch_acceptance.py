"""Where the time of BASELINE config 5 goes in the port, on one CUDA device.

    python3 tools/profile_torch_acceptance.py [--spp 20] [--chunks 3]

Config 5 is bouncing_spheres at 1200x675, 500 spp, depth 50. The forward
render goes through the default Renderer (phases [2, 3, 45], launches of
262,144 pixels x 1 sample); every launch has the same shape, so the
profiled render takes ``--spp`` samples of the 500 (its launches are 1 in
500/spp of the full render's). Then ``--chunks`` chunks of the fwd+bwd
sweep (``bench._fwd_bwd_setup`` at the config, spp_chunk 4, after its
planning sweep), each with its peak device memory, and one of them under
torch.profiler. Prints the card's name and power limit first; device
time by kernel, K1's, K2's and the fold's sums and the device's busy
share.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from raytracing_tpu_torch import Renderer, _kernels, build  # noqa: E402
from raytracing_tpu_torch import bench as pbench  # noqa: E402

SEED = 7
GROUPS = (("K1", "k1_trace_block"), ("K2", "k2_replay_bwd"), ("fold", "k4_table_fold"))


def summarize(prof, wall_s: float, label: str) -> None:
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    device_ms = sum(x[0] for x in rows) / 1e3
    sums = {k: (sum(x[0] for x in rows if name in x[1]) / 1e3,
                sum(x[2] for x in rows if name in x[1])) for k, name in GROUPS}
    print(f"{label}: wall {wall_s * 1e3:.2f} ms, device {device_ms:.2f} ms, busy share "
          f"{device_ms / (wall_s * 1e3):.3f}, " + ", ".join(
              f"{k} {ms:.3f} ms in {n} launches" for k, (ms, n) in sums.items()))
    for dt, key, count in rows[:12]:
        print(f"  {dt / 1e3:9.3f} ms {count:6d}  {key[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=20, help="samples of the profiled render")
    ap.add_argument("--chunks", type=int, default=3, help="fwd+bwd chunks timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _kernels.library()
    scene, cfg = build("bouncing_spheres", device=dev, image_width=1200,
                       samples_per_pixel=args.spp, max_depth=50)
    r = Renderer(cfg)
    r.render(scene, seed=SEED)
    runs = [r.render(scene, seed=SEED) for _ in range(3)]
    print(f"config 5 forward at {args.spp} spp: {runs[0].launches} launches, segments "
          f"{runs[0].segments}, render seconds {[round(x.seconds, 4) for x in runs]}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.render(scene, seed=SEED)
        wall = time.perf_counter() - t0
    summarize(prof, wall, f"profiled forward render ({args.spp} spp)")

    s = pbench._fwd_bwd_setup(width=1200, spp=500, max_depth=50, seed=SEED, spp_chunk=4,
                              device=dev)
    t0 = time.perf_counter()
    s["plan"]()
    torch.cuda.synchronize()
    print(f"planning sweep ({s['n_chunks']} chunks of {s['B']} rays): "
          f"{time.perf_counter() - t0:.3f} s, replay prefixes {s['ns']['prefixes']}")
    args5 = s["args"]
    for c in range(args.chunks):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = s["grads_chunk"](*args5, c * s["spp_chunk"])
        torch.cuda.synchronize()
        print(f"chunk {c}: {time.perf_counter() - t0:.4f} s, segments {int(out[4])}, ok "
              f"{bool(out[3])}, peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s["grads_chunk"](*args5, 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(prof, wall, "profiled fwd+bwd chunk")
    return 0


if __name__ == "__main__":
    sys.exit(main())
