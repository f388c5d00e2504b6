"""Seconds the cell's chunk programs took to warm up and capture as CUDA
graphs in set-up (``capture_seconds`` of each program the set-up made)."""


def read(ctx):
    return ctx["capture_s"] or None
