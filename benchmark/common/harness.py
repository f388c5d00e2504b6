"""One run of one cell: discovery by name, set-up, the measured window,
the metrics, and the check against the plain reference.

Everything is found by the names in ``BENCHMARK.json``:

* a cell ``<config>.<traffic>`` names a configuration, whose ``file``
  (``configs/<config>.json``) names the port's scene and the plain
  recipe beside it, and a traffic mix ``traffic/<traffic>.json``, whose
  ``job`` key names the job module ``jobs/<job>.py``;
* ``limits/<cell>.json`` holds the limit of each number the check compares;
* each metric ``<name>`` is read by ``metrics/<name>.py``'s ``read(ctx)``,
  which returns a number, or None where it finds nothing to read.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

from . import compare, profile

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CSRC = ROOT / "raytracing_tpu_torch" / "csrc"


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_file(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``<bench_dir>/<kind>/<name>.py`` (a name may hold dots)."""
    path = bench_dir / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell's configuration, traffic, limits, job module and metrics,
    found by name."""

    def __init__(self, spec: dict, name: str, bench_dir: Path = BENCH_DIR):
        self.name = name
        self.entry = find(spec["workloads"], name, "workload")
        conf_entry = find(spec["configs"], self.entry["config"], "config")
        self.config_path = bench_dir.parent / conf_entry["file"]
        self.conf = json.loads(self.config_path.read_text())
        self.traffic = json.loads(
            (bench_dir / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
        self.job_module = load_file("jobs", self.traffic["job"], bench_dir)
        self.end_to_end = [m for m in spec["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m, name)]
        self.bench_dir = bench_dir


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set-up, the window, the metrics and the check; returns the result
    line's fields (and ``checks``: each compared number with its limit)."""
    import torch

    cuda = torch.device(device).type == "cuda"
    parts = {"imports": time.perf_counter() - t_start}
    torch.empty(1, device=device)
    _sync(device)
    parts["device"] = time.perf_counter() - t_start
    job = cell.job_module.Job(cell.conf, cell.traffic, seed, device)
    _sync(device)
    parts["job"] = time.perf_counter() - t_start
    job.warm_up()
    _sync(device)
    counters = job.counters()
    for c in counters.values():
        c.reset()
    setup_peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    parts["warm_up"] = setup_s
    parts["capture"] = job.capture_seconds

    walls = []

    def window(until, span=contextlib.nullcontext):
        """Items one after another until ``until(elapsed)``; the seconds
        from the first item's start to the last one's end. ``span(name)``
        marks each item and each keep in a trace."""
        t0 = end = time.perf_counter()
        while not until(end - t0):
            start = time.perf_counter()
            with span("benchmark.item"):
                out = job.item()
            end = time.perf_counter()
            walls.append(end - start)
            with span("benchmark.keep"):
                job.keep(out)
        return end - t0

    if trace:
        from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        n_traced = cell.traffic["trace_items"]
        with torch_profile(activities=acts) as prof:
            with record_function(profile.WINDOW):
                window_s = window(lambda _: len(walls) >= n_traced, record_function)
    else:
        window_s = window(lambda elapsed: elapsed >= seconds)
    _sync(device)
    # reserved, not allocated: a replayed graph's buffers live in its pool,
    # which the allocator holds as reserved memory
    window_peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    ctx = dict(kind=cell.job_module.KIND,
               items=len(walls), walls=walls, window_s=window_s,
               samples_per_item=job.samples_per_item, setup_s=setup_s,
               capture_s=job.capture_seconds, peak_window_bytes=window_peak,
               counters={k: int(c) for k, c in counters.items()}, work=job.work(), trace=None)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.entry["chips"],
                   "memory_peak_bytes": max(setup_peak, window_peak)}
    breakdown = None
    if trace:
        events = prof.events()
        dev_ev, host_ev = profile.device_events(events), profile.host_events(events)
        lo, hi = profile.window(host_ev)
        kernels = profile.by_name(dev_ev, lo, hi)
        busy = profile.busy_seconds(dev_ev, lo, hi)
        ctx["trace"] = dict(busy_s=busy, traced_window_s=(hi - lo) * 1e-6, kernels=kernels,
                            port_kernels=profile.port_kernel_names(CSRC))
        device_info.update(busy_s=busy, window_s=(hi - lo) * 1e-6)
        breakdown = {"device_ops": profile.top_ops(kernels),
                     "idle_gaps": profile.idle_gaps(dev_ev, host_ev, lo, hi)}
        del prof, events, dev_ev, host_ev
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_file("metrics", m["name"], cell.bench_dir).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the reference runs on the card once the program's state is freed
    job.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    per_item = job.check(cell.config_path, device)
    print(f"benchmark: {len(walls)} items in {window_s:.3f} s, set-up {setup_s:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    print("benchmark: set-up done at (s) " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
          file=sys.stderr)
    worst, failed = compare.judge(per_item, cell.limits)
    out = {"correct": bool(per_item) and failed == 0, "attempted": len(walls),
           "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["setup_parts"] = parts
    out["checks"] = {k: {"value": worst[k], "limit": cell.limits[k]} for k in cell.limits}
    return out
