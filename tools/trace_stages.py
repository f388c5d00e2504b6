"""The port's stage clock and spans on a benchmark cell, on one CUDA device.

    python3 tools/trace_stages.py --workload <cell> [--seed N] [--items K] [--out F]
                                  [--schedule pool]
    python3 tools/trace_stages.py --workload <cell> --cost SECONDS [--rounds R]
    python3 tools/trace_stages.py --probe

The cell (``BENCHMARK.json``: its configuration, traffic and job) is set
up as ``benchmark/run.py`` sets it up, but with the port's tracing switch
on (``raytracing_tpu_torch/utils/profiling.py``) before the job is built,
so the warm-up captures the stage marks.

* Default: ``K`` items (the mix's ``trace_items``) under ``torch.profiler``;
  prints one JSON line: each stage's device ms and calls an item, their
  sum against the device's busy time (the union of the traced operations,
  as the benchmark takes it), the ``k1`` and ``k2`` stages against the
  profiler's own ``k1_trace_block`` and ``k2_replay_bwd`` device time and
  against the launch counters, the share of the busy time that lies
  inside a stage (between the traced marks), the marks' own traced time,
  and the idle time of the window by the innermost ``rt.`` span open over
  it.
* ``--cost``: the cost of the switch when on. Windows of ``SECONDS`` of
  items with no profiler, the switch off and on in turns (off, on, on,
  off, ... for ``R`` rounds; a switch turned over captures new programs
  in one untimed item first); prints the cell's rate (camera samples a
  second, the benchmark's end-to-end metric) of every window.
* ``--schedule pool`` (a render cell): renders through the regenerating
  pool instead, each sample window one WHILE graph launch, whose kernels
  the profiler does not see but the stage clock does.
* ``--probe``: ``%globaltimer``'s update period, and the cost of one mark
  pair in a captured graph (the replay time of a graph of 256 empty
  stages over 256) and the device time an empty stage reads.

Prints the card's name and power limit first (stderr). Needs a CUDA
device; run from the repository's root.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.common import harness  # noqa: E402
from benchmark.common import profile as bprof  # noqa: E402
from raytracing_tpu_torch import _kernels  # noqa: E402
from raytracing_tpu_torch.utils import profiling as pf  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def set_up(name: str, seed: int, dev, on: bool, schedule=None):
    cell = harness.Cell(harness.load_spec(), name)
    if schedule is not None:
        cell.traffic["renderer"] = dict(cell.traffic["renderer"], schedule=schedule)
    pf.enable(on)
    job = cell.job_module.Job(cell.conf, cell.traffic, seed, dev)
    job.warm_up()
    torch.cuda.synchronize(dev)
    return cell, job


def traced(name: str, seed: int, items, dev, schedule=None) -> dict:
    cell, job = set_up(name, seed, dev, True, schedule)
    items = items or cell.traffic["trace_items"]
    counters = job.counters()
    for c in counters.values():
        c.reset()
    pf.reset_stages()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(bprof.WINDOW):
            for _ in range(items):
                job.item()
    torch.cuda.synchronize(dev)
    totals = pf.stage_totals(dev)
    counts = {k: int(c) for k, c in counters.items()}
    events = prof.events()
    dev_ev, host_ev = bprof.device_events(events), bprof.host_events(events)
    lo, hi = bprof.window(host_ev)
    kernels = bprof.by_name(dev_ev, lo, hi)
    busy = bprof.busy_seconds(dev_ev, lo, hi)
    idle = pf.idle_by_span([(s, e) for _, s, e in dev_ev], host_ev, lo, hi)
    stages = totals["stages"]
    stage_sum = sum(s for s, _ in stages.values())
    marks = [v for n, v in kernels.items() if bprof.kernel_of(n, ("rt_stage_mark",))]
    covered = busy_in_stages(dev_ev, lo, hi)

    def vs(stage, ident, counter):
        if stage not in stages:
            return None
        s, calls = stages[stage]
        p = bprof.seconds_of(kernels, ident)
        return dict(stage_ms=1e3 * s, profiler_ms=1e3 * p, rel=(s - p) / p if p else None,
                    calls=calls, launches=counts.get(counter))

    per = 1e3 / items
    return dict(
        cell=name, schedule=schedule, seed=seed, device=totals["device"], clock=totals["clock"], items=items,
        stage_ms_per_item={k: s * per for k, (s, _) in stages.items()},
        stage_calls_per_item={k: c / items for k, (_, c) in stages.items()},
        stage_sum_ms_per_item=stage_sum * per, busy_ms_per_item=busy * per,
        window_ms_per_item=(hi - lo) * 1e-3 / items,
        coverage=stage_sum / busy if busy else None,
        busy_in_stages_share=covered / busy if busy else None,
        k1=vs("k1", "k1_trace_block", "k1_launches"),
        k2=vs("k2", "k2_replay_bwd", "k2_launches"),
        mark_ms_per_item=sum(v[0] for v in marks) * per,
        marks_per_item=sum(v[1] for v in marks) / items,
        idle_ms_per_item_by_span={k: v * per for k, v in sorted(idle.items())},
        top_ops=[[n, s * per] for n, s in bprof.top_ops(kernels, 12)])


def busy_in_stages(dev_ev, lo, hi) -> float:
    """Seconds of the device's busy time (the union of its operations in
    ``[lo, hi]``) that lie inside a stage: between a begin mark's end and
    the next end mark's start, the traced marks taken in pairs (stages do
    not nest and run on one stream)."""
    marks = sorted((s, e) for n, s, e in dev_ev
                   if lo <= s <= hi and bprof.kernel_of(n, ("rt_stage_mark",)))
    inside = [(b[1], e[0]) for b, e in zip(marks[::2], marks[1::2])]
    busy = bprof.union([(s, e) for n, s, e in dev_ev
                        if not bprof.kernel_of(n, ("rt_stage_mark",))], lo, hi)
    total, k = 0.0, 0
    for s, e in busy:
        while k < len(inside) and inside[k][1] <= s:
            k += 1
        j = k
        while j < len(inside) and inside[j][0] < e:
            total += max(0.0, min(e, inside[j][1]) - max(s, inside[j][0]))
            j += 1
    return total * 1e-6


def cost(name: str, seed: int, seconds: float, rounds: int, dev) -> dict:
    """Windows with the switch off and on in turns, as ``benchmark/run.py``
    times a window (items one after another, the seconds from the first
    item's start to the last one's end)."""
    cell, job = set_up(name, seed, dev, False)
    rates = {False: [], True: []}
    order = [on for r in range(rounds) for on in ((False, True) if r % 2 == 0 else (True, False))]
    current = False
    for on in order:
        if on != current:
            pf.enable(on)
            job.item()  # captures the programs of this setting
            torch.cuda.synchronize(dev)
            current = on
        n, t0 = 0, time.perf_counter()
        end = t0
        while end - t0 < seconds:
            job.item()
            n += 1
            end = time.perf_counter()
        rates[on].append(n * job.samples_per_item / (end - t0))
        print(f"cost {name}: switch {'on ' if on else 'off'} {rates[on][-1]:.6e} samples/s "
              f"({n} items)", file=sys.stderr, flush=True)
    pf.enable(False)
    med = {k: statistics.median(v) for k, v in rates.items()}
    return dict(cell=name, seed=seed, seconds=seconds, order=order,
                rate_off=rates[False], rate_on=rates[True],
                cost=1.0 - med[True] / med[False])


def probe(dev) -> dict:
    lib = _kernels.library().lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.zeros(4, dtype=torch.int64, device=dev)
    n_reads = 1 << 20
    assert lib.rt_globaltimer_probe_launch(out.data_ptr(), n_reads, ctypes.c_void_p(stream)) == 0
    changes, lo, hi, span = out.tolist()

    n = 256
    pf.enable(True)
    try:
        def stages():
            for _ in range(n):
                with pf.stage("camera", dev):
                    pass

        stages()  # allocates the clock outside capture
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            stages()
        graph.replay()
        torch.cuda.synchronize(dev)
        pf.reset_stages()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reps = 20
        e0.record()
        for _ in range(reps):
            graph.replay()
        e1.record()
        torch.cuda.synchronize(dev)
        pair_us = e0.elapsed_time(e1) * 1e3 / (reps * n)
        s, calls = pf.stage_totals(dev)["stages"]["camera"]
    finally:
        pf.enable(False)
        pf.reset_stages()
    return dict(globaltimer=dict(reads=n_reads, changes=changes, min_step_ns=lo, max_step_ns=hi,
                                 span_ns=span, period_ns=span / changes if changes else None),
                mark_pair_us_in_graph=pair_us, empty_stage_reads_us=1e6 * s / calls,
                empty_stage_calls=calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/trace_stages.py")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=2**40 + 17)
    ap.add_argument("--items", type=int, default=None)
    ap.add_argument("--cost", type=float, default=None, metavar="SECONDS")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--schedule", choices=("pool",), default=None)
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_stages: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"card: {card()}", file=sys.stderr, flush=True)
    if args.probe:
        res = probe(dev)
    elif args.cost is not None:
        res = cost(args.workload, args.seed, args.cost, args.rounds, dev)
    else:
        res = traced(args.workload, args.seed, args.items, dev, args.schedule)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
