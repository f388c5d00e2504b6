"""Formulas that several metrics share; each metric's own file
(``metrics/<name>.py``) calls one with the kind of cell it reads. Each
returns None where the run has nothing for it to read."""
from __future__ import annotations

from . import profile


def samples_per_s(ctx, kind: str):
    """Camera samples (pixels × spp) of every item completed in the window,
    over the seconds from the window's start to the last item's end."""
    if ctx["kind"] != kind or not ctx["items"]:
        return None
    return ctx["items"] * ctx["samples_per_item"] / ctx["window_s"]


def idle_pct(ctx, kind: str):
    """100 less the union of the device's operations over the traced
    window's length."""
    tr = ctx["trace"]
    if ctx["kind"] != kind or tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["traced_window_s"])


def kernel_ms_per_item(ctx, kind: str, ident: str):
    """Device ms an item of the kernel ``ident`` in the trace."""
    tr = ctx["trace"]
    if ctx["kind"] != kind or tr is None or not ctx["items"]:
        return None
    secs = profile.seconds_of(tr["kernels"], ident)
    return 1e3 * secs / ctx["items"] if secs > 0 else None
