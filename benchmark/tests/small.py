"""A copy of the benchmark with small traffic, for runs on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# small versions of each mix: every check pixel sampled, so the segment
# estimate is exact
SMALL = {
    "final_render": dict(image_width=40, samples_per_pixel=4, max_depth=6, check_pixels=10**6,
                         trace_items=1),
    "render": dict(image_width=24, samples_per_pixel=4, max_depth=10, check_pixels=10**6,
                   trace_items=1),
    "grad_sweep": dict(image_width=64, samples_per_pixel=16, max_depth=6, trace_items=1),
    "final_grad": dict(image_width=48, samples_per_pixel=8, max_depth=12, trace_items=1),
}


def small_copy(dest: Path) -> Path:
    """``dest`` with BENCHMARK.json and benchmark/ at small traffic; returns
    the copy's benchmark directory."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    bench = dest / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for mix, upd in SMALL.items():
        p = bench / "traffic" / f"{mix}.json"
        d = json.loads(p.read_text())
        d.update(upd)
        p.write_text(json.dumps(d))
    return bench


def run_small(bench: Path, cell: str, seed: int = 2**40 + 7, trace: bool = False) -> dict:
    import time

    import torch

    from benchmark.common import harness

    spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
    c = harness.Cell(spec, cell, bench)
    return harness.run(c, seed, 0.5, trace, torch.device("cpu"), time.perf_counter())
