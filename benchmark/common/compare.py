"""What decides ``correct``: the numbers compared between the program's
outputs and the plain reference's, and the draws from ``--seed`` that
both sides share.

Renders: the mean absolute difference of the sampled pixels' mean
radiance over their three channels (``pixel_mae``), and the relative gap
between the image's segment count and the reference's estimate of it,
the sampled pixels' segments scaled to the whole image
(``segments_rel``). Sweeps: the relative gap of the loss (``loss_rel``),
of the segment count (``segments_rel``) and of each gradient as a whole
(``grad_rel_l2``, the worse of the centres' and the colours'), and the
worst row of either gradient (``grad_worst_row``): a row's difference
over the larger of its reference norm and the median row's. A number
that is not finite reads +inf.
"""
from __future__ import annotations

import math

import numpy as np


def render_seed(seed: int) -> int:
    """The renderer's seed for a run's ``--seed`` (any whole number)."""
    return int(np.random.default_rng(seed % 2**64).integers(0, 2**31 - 1))


def pixel_sample(seed: int, n_pixels: int, count: int) -> np.ndarray:
    """``count`` pixel ids spread evenly over the whole image in raster
    order: ``floor((k + u) · n_pixels / count)``, ``u`` drawn from ``seed``."""
    count = min(count, n_pixels)
    u = float(np.random.default_rng([seed % 2**64, 1]).random())
    return np.floor((np.arange(count) + u) * (n_pixels / count)).astype(np.int64)


def _finite(x: float) -> float:
    return float(x) if math.isfinite(x) else math.inf


def render_numbers(px, segments: int, ok: bool, ref_px, ref_segs, n_pixels: int) -> dict:
    estimate = float(ref_segs.astype(np.float64).mean()) * n_pixels
    mae = float(np.abs(px.astype(np.float64) - ref_px.astype(np.float64)).mean())
    return {"pixel_mae": _finite(mae),
            "segments_rel": _finite(abs(segments - estimate) / estimate) if ok else math.inf}


def _rel_l2(g, r) -> float:
    return float(np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30))


def _worst_row(g, r) -> float:
    diff = np.linalg.norm(g - r, axis=1)
    norms = np.linalg.norm(r, axis=1)
    return float(np.max(diff / np.maximum(norms, max(np.median(norms), 1e-30))))


def grad_numbers(loss, gc, gr, segments, ok, ref_loss, ref_gc, ref_gr, ref_segments) -> dict:
    n = ref_gc.shape[0]
    if gc.shape[0] < n or gr.shape != ref_gr.shape or not ok:
        return {k: math.inf for k in ("loss_rel", "segments_rel", "grad_rel_l2",
                                      "grad_worst_row")}
    gc, gr = gc[:n].astype(np.float64), gr.astype(np.float64)
    ref_gc, ref_gr = ref_gc.astype(np.float64), ref_gr.astype(np.float64)
    return {"loss_rel": _finite(abs(loss - ref_loss) / abs(ref_loss)),
            "segments_rel": _finite(abs(segments - ref_segments) / ref_segments),
            "grad_rel_l2": _finite(max(_rel_l2(gc, ref_gc), _rel_l2(gr, ref_gr))),
            "grad_worst_row": _finite(max(_worst_row(gc, ref_gc), _worst_row(gr, ref_gr)))}


def judge(per_item: list, limits: dict):
    """(worst reading of each number over the items, items over a limit)."""
    worst = {k: max(x[k] for x in per_item) for k in limits} if per_item else {}
    failed = sum(any(not (x[k] <= limits[k]) for k in limits) for x in per_item)
    return worst, failed
