"""Where the time of the port's fwd+bwd sweep goes, on one CUDA device.

    python3 tools/profile_torch_fwd_bwd.py

Builds the fwd+bwd bench (raytracing_tpu_torch.bench._fwd_bwd_setup:
bouncing_spheres 400x225, 100 spp, depth 20, seed 7, 25 chunks of
360,448 rays), plans it, then: five timed sweeps (host clock through
torch.cuda.synchronize), one sweep under torch.profiler (device time by
kernel, device busy share), and CUDA-event timings of one whole chunk.
Prints the card's name, power limit and max SM clock first.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from raytracing_tpu_torch import _kernels  # noqa: E402
from raytracing_tpu_torch import bench  # noqa: E402

from profile_torch_render import event_ms  # noqa: E402


def timed_sweep(s):
    t0 = time.perf_counter()
    out = s["sweep"]()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    _kernels.library()
    s = bench._fwd_bwd_setup(device="cuda")
    print("prefixes", s["plan"](), "decide prefixes", s["ns"]["decide_prefixes"])
    s["sweep"]()
    runs = [timed_sweep(s) for _ in range(5)]
    segs = int(runs[0][1][3])
    print("sweep seconds", [round(t, 4) for t, _ in runs], "segments", segs,
          "ok", [bool(o[4]) for _, o in runs])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = timed_sweep(s)
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    device_ms = sum(x[0] for x in rows) / 1e3
    print(f"profiled sweep: wall {wall * 1e3:.2f} ms, device {device_ms:.2f} ms, "
          f"busy share {device_ms / (wall * 1e3):.3f}, kernels launched {sum(x[2] for x in rows)}")
    for dt, key, count in rows[:25]:
        print(f"  {dt / 1e3:9.3f} ms {count:6d}  {key[:100]}")

    center, rgb = s["args"]
    d_ms, h_ms = event_ms(lambda: s["grads_chunk"](center, rgb, 0), reps=10)
    print(f"whole chunk: device span {d_ms:.3f} ms, host {h_ms:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
