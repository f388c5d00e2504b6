"""Run one cell of the benchmark of raytracing_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. The cell, its configuration, its traffic mix,
its limits and its metrics are found by the names in ``BENCHMARK.json``
(``common/harness.py``). The run sets up the cell (its scene, one
warm-up item, which builds the kernels and captures the programs), then
runs items one after another for ``--seconds`` (``--trace 1``: the
mix's ``trace_items`` under ``torch.profiler``), then checks every item
against the plain reference (``reference/``), on the card, after the
program's state is freed.

It prints, as the last lines on standard error, each number compared
with its limit, and as the last line on standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

It exits with 2 and prints no result without enough CUDA devices, and
with 3 if JAX or the JAX package (``raytracing_tpu``) was imported.
Caches live in the checkout: the port's kernels in
``raytracing_tpu_torch/_build/`` and any other compiler cache under
``.cache/`` at the root.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    cache = ROOT / ".cache"
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from benchmark.common import guard, harness

    cell = harness.Cell(harness.load_spec(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.entry['chips']} CUDA device(s), "
              f"found {n}", file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      T_START)
    found = guard.forbidden(sys.modules)
    if found:
        print(f"benchmark: the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])  # keeps the line strict JSON
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
