"""Intersection constants and the quad plane basis, the counterparts of
``raytracing_tpu.ops.intersect``."""
from __future__ import annotations

import torch

T_MIN = 1e-3         # shadow-acne epsilon: roots at t <= T_MIN are rejected
PARALLEL_EPS = 1e-8  # |n·d| below this: the ray is parallel to a quad's plane


def quad_plane_basis(quads):
    """(unit normal (M, 3), plane D (M,)) of every quad from (q, u, v),
    with autograd, op for op as the JAX package computes it (normal =
    n · 1/√(n·n); degenerate quads get a zero normal). ``scene/flatten.py``
    divides by √(n·n) instead, so its tables are not this arithmetic."""
    n = torch.linalg.cross(quads.u, quads.v)
    nn = (n * n).sum(-1)
    normal = n * (1.0 / torch.sqrt(torch.where(nn > 0, nn, 1.0)))[:, None]
    return normal, (normal * quads.q).sum(-1)
