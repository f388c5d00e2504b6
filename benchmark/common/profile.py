"""Reductions of a ``torch.profiler`` trace of the measured window.

* device intervals: every operation the trace saw on the card (kernels,
  copies and fills), kernels inside replayed CUDA graphs included; a
  kernel inside a graph's WHILE node is not traced;
* busy seconds: the length of the union of those intervals inside the
  window (not their sum, which counts overlapping work twice);
* device seconds and launches by kernel name;
* idle gaps: the stretches of the window with nothing on the device, each
  named by the innermost host operation open at its middle.

The window is the host span the harness records around its items
(``record_function(WINDOW)``). Times in the trace are microseconds.
"""
from __future__ import annotations

import re
from pathlib import Path

WINDOW = "benchmark.window"
NAME_CHARS = 160  # names in a breakdown are cut to this length


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).upper().endswith("CUDA")


def device_events(events) -> list:
    """(name, start_us, end_us) of every operation on the card; the device
    side of a host span (a user annotation) is not one."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if _is_device(e) and not getattr(e, "is_user_annotation", False)
            and e.name != WINDOW]


def host_events(events) -> list:
    """(name, start_us, end_us) of every host operation."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if not _is_device(e)]


def window(host: list):
    """(start_us, end_us) of the harness's window span, or None."""
    spans = [(s, e) for n, s, e in host if n == WINDOW]
    return (min(s for s, _ in spans), max(e for _, e in spans)) if spans else None


def union(intervals, lo: float, hi: float) -> list:
    """The merged intervals, clipped to [lo, hi]."""
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(device: list, lo: float, hi: float) -> float:
    return sum(e - s for s, e in union([(s, e) for _, s, e in device], lo, hi)) * 1e-6


def by_name(device: list, lo: float, hi: float) -> dict:
    """{name: [device seconds, count]} of the operations that start in the window."""
    out = {}
    for name, s, e in device:
        if lo <= s <= hi:
            row = out.setdefault(name, [0.0, 0])
            row[0] += (e - s) * 1e-6
            row[1] += 1
    return out


def idle_gaps(device: list, host: list, lo: float, hi: float, top: int = 10) -> list:
    """The ``top`` longest stretches of [lo, hi] with nothing on the card:
    [[host operation open at its middle, seconds], ...], longest first."""
    busy = union([(s, e) for _, s, e in device], lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[k + 1] - edges[k], edges[k], edges[k + 1])
                   for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]),
                  reverse=True)[:top]
    out = []
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        open_ = [(hs, -(he - hs), n) for n, hs, he in host
                 if hs <= mid <= he and n != WINDOW]
        name = max(open_)[2] if open_ else "no host operation traced"
        out.append([name[:NAME_CHARS], length * 1e-6])
    return out


def top_ops(kernels: dict, top: int = 10) -> list:
    """[[name, device seconds], ...] of the ``top`` operations by device time."""
    rows = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:top]
    return [[name[:NAME_CHARS], secs] for name, (secs, _) in rows]


def port_kernel_names(csrc: Path) -> set:
    """The ``__global__`` functions of the program's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    return {m.group(1) for f in sorted(Path(csrc).glob("*.cu"))
            for m in pat.finditer(f.read_text())}


def kernel_of(name: str, idents) -> str | None:
    """Which of ``idents`` the traced operation ``name`` is, or None."""
    for ident in idents:
        if re.search(rf"\b{re.escape(ident)}\b", name):
            return ident
    return None


def seconds_of(kernels: dict, ident: str) -> float:
    """Device seconds of the kernel ``ident`` in a ``by_name`` table."""
    return sum(v[0] for n, v in kernels.items() if kernel_of(n, (ident,)))


def is_kernel(name: str) -> bool:
    """False for the trace's copies and fills."""
    return not name.startswith(("Memcpy", "Memset"))
