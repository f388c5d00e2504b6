"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9]

For every ``--seeds`` seed: the cell's set-up and warm-up as a run makes
them, one timed item, then the check against the plain reference, as
``benchmark/run.py`` does. For every ``--control-seeds`` seed: the plain
reference computed in bfloat16, put in the program's place, against the
float32 reference, at the cell's own size (a seed in both lists computes
the float32 reference once). One JSON line a seed and side with every
number compared. The lower reading of a number is the largest over the
program's seeds, its upper reading the smallest the control gives. The
benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.common import compare, harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.Cell(harness.load_spec(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds + [c for c in controls if c not in seeds]:
        t0 = time.perf_counter()
        job = cell.job_module.Job(cell.conf, cell.traffic, seed, dev)
        if seed in seeds:
            job.warm_up()
            job.keep(job.item())
        job.release()
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ref = job.reference(cell.config_path, dev)
        if seed in seeds:
            nums = compare.judge(job.check(cell.config_path, dev, ref), cell.limits)[0]
            print(json.dumps({"cell": cell.name, "side": "program", "seed": seed,
                              "numbers": nums, "run_s": t1 - t0,
                              "check_s": time.perf_counter() - t1}), flush=True)
        if seed in controls:
            t2 = time.perf_counter()
            low = job.reference(cell.config_path, dev, torch.bfloat16)
            print(json.dumps({"cell": cell.name, "side": "control bfloat16", "seed": seed,
                              "numbers": job.control_numbers(low, ref),
                              "check_s": time.perf_counter() - t2}), flush=True)
        del job, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
