"""Vector math on ``(..., 3)`` tensors, the counterpart of
``raytracing_tpu.core.vecmath``: shape-polymorphic over leading batch
dimensions and differentiable. A 3-vector is the trailing axis of a
tensor; there is no vector class.

Sums over the three components are written out as ``x0 + x1 + x2`` (in
that order), so every caller rounds them the same way whatever the
tensor's layout.
"""
from __future__ import annotations

import torch

# a scatter direction with every component below this is degenerate
# (the lambertian scatter then falls back to the normal)
NEAR_ZERO_EPS = 1e-8


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis."""
    return torch.linalg.cross(a, b)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Unit vector ``v / |v|``."""
    return v / torch.sqrt(length_squared(v))[..., None]


def near_zero(v: torch.Tensor, eps: float = NEAR_ZERO_EPS) -> torch.Tensor:
    """True where every component is below ``eps`` in magnitude."""
    return torch.all(torch.abs(v) < eps, dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection ``v - 2 (v·n) n``."""
    return v - 2.0 * dot(v, n)[..., None] * n


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at 0 with a zero gradient at x <= 0. The inner
    ``where`` keeps sqrt(0)'s infinite derivative out of the graph: a
    gradient of 0 through an untaken branch would otherwise meet it as
    0·∞ = NaN."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def refract(uv: torch.Tensor, n: torch.Tensor, etai_over_etat: torch.Tensor) -> torch.Tensor:
    """Snell refraction of the unit direction ``uv`` through the normal
    ``n`` with relative index ``etai_over_etat`` (batched ``(...,)``), by
    the perpendicular/parallel split. The parallel part's sqrt is guarded
    like :func:`safe_sqrt`: at total internal reflection its argument is
    0, and rays that reflect instead must not get a NaN gradient."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    k = torch.abs(1.0 - length_squared(r_out_perp))
    k_pos = k > 0.0
    root = torch.where(k_pos, torch.sqrt(torch.where(k_pos, k, 1.0)), 0.0)
    return r_out_perp + (-root[..., None] * n)


def ray_at(origin: torch.Tensor, direction: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``P(t) = O + t·D``."""
    return origin + t[..., None] * direction


def set_face_normal(ray_dir: torch.Tensor, outward_normal: torch.Tensor):
    """Orient the normal against the ray: ``(normal, front_face)`` with
    ``front_face = d·n_out < 0``."""
    front_face = dot(ray_dir, outward_normal) < 0.0
    normal = torch.where(front_face[..., None], outward_normal, -outward_normal)
    return normal, front_face
