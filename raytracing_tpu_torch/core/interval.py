"""Interval tests on ``(lo, hi)`` pairs of tensors or numbers, the
counterpart of ``raytracing_tpu.core.interval``. Hits use the open
``surrounds`` test; the quad interior test uses the closed ``contains``."""
from __future__ import annotations


def contains(lo, hi, x):
    """Closed containment: lo <= x <= hi."""
    return (lo <= x) & (x <= hi)


def surrounds(lo, hi, x):
    """Open containment: lo < x < hi."""
    return (lo < x) & (x < hi)
