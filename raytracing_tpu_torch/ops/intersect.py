"""Ray–primitive intersection and the brute-force closest hit, the
counterpart of ``raytracing_tpu.ops.intersect``: every (ray, primitive)
pair gets a candidate ``t`` (+inf on a miss) and the closest hit is an
argmin, differentiable in the scene's and the rays' tensors.

Hits use the open ``surrounds`` test; a quad's interior test is closed.
Dot products over the three components are written out per component
(``(B, N)`` tensors, no ``(B, N, 3)`` temporaries), in the JAX package's
summation order. Sphere roots take the correctly rounded float32 square
root (:func:`sqrt_rn`: float32 on the card, through float64 on the CPU,
whose vectorised float32 ``sqrt`` is off by an ulp on some inputs, so
that the sweep (``(B, N)``) and the replay (``(B,)``) would split on rays
that graze a sphere).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import interval as iv
from ..core import vecmath as vm
from ..scene.types import Scene

T_MIN = 1e-3         # shadow-acne epsilon: roots at t <= T_MIN are rejected
PARALLEL_EPS = 1e-8  # |n·d| below this: the ray is parallel to a quad's plane
BIG = float("inf")   # the candidate t of a miss


@dataclass
class HitBatch:
    """Hit records of a batch of rays, struct of arrays."""
    valid: torch.Tensor       # (B,) bool
    t: torch.Tensor           # (B,) f32, +inf on a miss
    p: torch.Tensor           # (B, 3) hit point
    normal: torch.Tensor      # (B, 3) unit, against the ray
    front_face: torch.Tensor  # (B,) bool
    u: torch.Tensor           # (B,) f32 surface coordinate
    v: torch.Tensor           # (B,) f32 surface coordinate
    mat_id: torch.Tensor      # (B,) i32
    prim_id: torch.Tensor     # (B,) i32 global primitive id, -1 on a miss


class _Sqrt32(torch.autograd.Function):
    """float32 ``torch.sqrt`` forward, with the float64 route's backward:
    autograd through ``torch.sqrt(x.double()).float()`` takes the
    cotangent to float64, divides it by twice the float64 root and rounds
    to float32, so gradients do not depend on which route the forward
    took."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sqrt(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.double() / (2 * torch.sqrt(x.double()))).float()


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt rounded to nearest, as CUDA's ``sqrtf``, with autograd.
    On a CUDA tensor PyTorch's float32 sqrt is correctly rounded (equal to
    the float64 route on 2^24 random inputs and the edge values, forward
    and backward: chip_smoke.py phase 9, tests/test_torch_cuda.py);
    elsewhere a float64 sqrt rounded to float32 is (PyTorch's vectorized
    CPU float32 sqrt is off by an ulp on ~0.7% of inputs)."""
    if x.is_cuda:
        return _Sqrt32.apply(x)
    return torch.sqrt(x.double()).float()


class _Atan2F64(torch.autograd.Function):
    """atan2 through float64, rounded to float32, with float32
    ``torch.atan2``'s backward (the gradient the float32 formula gives)."""

    @staticmethod
    def forward(ctx, y, x):
        ctx.save_for_backward(y, x)
        return torch.atan2(y.double(), x.double()).float()

    @staticmethod
    def backward(ctx, g):
        y, x = (v.detach().requires_grad_() for v in ctx.saved_tensors)
        with torch.enable_grad():
            return torch.autograd.grad(torch.atan2(y, x), (y, x), g)


def atan2_rn(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 ``atan2(y, x)`` that depends on nothing but its inputs,
    with autograd. On a CUDA tensor it is ``torch.atan2`` (CUDA's
    ``atan2f``, as the kernels call it); elsewhere a float64 atan2 rounded
    to float32, since PyTorch's CPU float32 atan2 gives results that depend
    on the thread count and on an element's position in the tensor. The
    gradient is float32 ``torch.atan2``'s either way."""
    if y.is_cuda:
        return torch.atan2(y, x)
    return _Atan2F64.apply(y, x)


def safe_sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """:func:`vecmath.safe_sqrt <raytracing_tpu_torch.core.vecmath.safe_sqrt>`
    through :func:`sqrt_rn`."""
    pos = x > 0.0
    return torch.where(pos, sqrt_rn(torch.where(pos, x, 1.0)), 0.0)


def sphere_centers_at(scene: Scene, time: torch.Tensor):
    """Sphere centres at the rays' times as three components: ``(B, N)``
    each when the scene has moving spheres, else ``(1, N)``."""
    sph = scene.spheres
    c = sph.center
    if scene.flags.has_moving:
        v = sph.velocity
        tm = time[:, None]
        return (c[None, :, 0] + tm * v[None, :, 0], c[None, :, 1] + tm * v[None, :, 1],
                c[None, :, 2] + tm * v[None, :, 2])
    return c[None, :, 0], c[None, :, 1], c[None, :, 2]


def _t_max_col(t_max):
    return t_max[:, None] if torch.is_tensor(t_max) and t_max.dim() == 1 else t_max


def sphere_ts(scene: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
              t_min=T_MIN, t_max=BIG) -> torch.Tensor:
    """Candidate t per (ray, sphere), ``(B, N)``, +inf on a miss: the
    half-b quadratic and the nearest root inside (t_min, t_max)."""
    sph = scene.spheres
    cx, cy, cz = sphere_centers_at(scene, time)
    ocx, ocy, ocz = o[:, 0:1] - cx, o[:, 1:2] - cy, o[:, 2:3] - cz
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    a = vm.length_squared(d)[:, None]
    half_b = ocx * dx + ocy * dy + ocz * dz
    cq = (ocx * ocx + ocy * ocy + ocz * ocz) - (sph.radius * sph.radius)[None, :]
    disc = half_b * half_b - a * cq
    sqrtd = safe_sqrt_rn(disc)
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    t_max = _t_max_col(t_max)
    ok0 = iv.surrounds(t_min, t_max, root0)
    ok1 = iv.surrounds(t_min, t_max, root1)
    root = torch.where(ok0, root0, root1)
    hit = (disc >= 0.0) & (ok0 | ok1) & (sph.radius > 0.0)[None, :]
    return torch.where(hit, root, BIG)


def quad_plane_basis(quads):
    """Plane parameters of every quad from (q, u, v), with autograd:
    ``(unit normal (M, 3), plane D (M,), w = n/(n·n) (M, 3), degenerate
    (M,) bool)``. A degenerate quad (u × v = 0) gets a zero normal.
    ``scene/flatten.py`` divides by √(n·n) instead, so its tables are not
    this arithmetic."""
    n = vm.cross(quads.u, quads.v)
    nn = vm.length_squared(n)
    safe_nn = torch.where(nn > 0, nn, 1.0)
    normal = n * (1.0 / torch.sqrt(safe_nn))[:, None]
    dconst = vm.dot(normal, quads.q)
    w = n / safe_nn[:, None]
    return normal, dconst, w, nn == 0.0


def quad_ts(scene: Scene, o: torch.Tensor, d: torch.Tensor, t_min=T_MIN,
            t_max=BIG) -> torch.Tensor:
    """Candidate t per (ray, quad), ``(B, M)``, +inf on a miss: the plane
    solve and the (α, β) interior test."""
    qd = scene.quads
    normal, dconst, w, degenerate = quad_plane_basis(qd)
    nx, ny, nz = normal[None, :, 0], normal[None, :, 1], normal[None, :, 2]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    denom = nx * dx + ny * dy + nz * dz
    safe_denom = torch.where(torch.abs(denom) < PARALLEL_EPS, 1.0, denom)
    n_dot_o = nx * ox + ny * oy + nz * oz
    t = (dconst[None, :] - n_dot_o) / safe_denom
    px = ox + t * dx - qd.q[None, :, 0]
    py = oy + t * dy - qd.q[None, :, 1]
    pz = oz + t * dz - qd.q[None, :, 2]
    ux, uy, uz = qd.u[None, :, 0], qd.u[None, :, 1], qd.u[None, :, 2]
    vx, vy, vz = qd.v[None, :, 0], qd.v[None, :, 1], qd.v[None, :, 2]
    wx, wy, wz = w[None, :, 0], w[None, :, 1], w[None, :, 2]
    # α = w·(planar × v), β = w·(u × planar)
    alpha = wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz) + wz * (px * vy - py * vx)
    beta = wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz) + wz * (ux * py - uy * px)
    hit = ((torch.abs(denom) >= PARALLEL_EPS) & ~degenerate[None, :]
           & iv.surrounds(t_min, _t_max_col(t_max), t)
           & iv.contains(0.0, 1.0, alpha) & iv.contains(0.0, 1.0, beta))
    return torch.where(hit, t, BIG)


def hit_attributes(scene: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                   t: torch.Tensor, prim_id: torch.Tensor) -> HitBatch:
    """Hit records for the winning primitive of each ray (``t`` (B,), +inf
    on a miss; ``prim_id`` (B,) global ids, sphere i → i, quad j →
    n_spheres + j): point, oriented normal, front face, surface
    coordinates (sphere UV, quad (α, β)) and material."""
    n_sph = scene.n_spheres
    valid = torch.isfinite(t)
    t_safe = torch.where(valid, t, 0.0)
    p = vm.ray_at(o, d, t_safe)

    pid = prim_id.long()
    is_quad = pid >= n_sph
    sid = torch.clamp(pid, 0, n_sph - 1)
    qid = torch.clamp(pid - n_sph, 0, scene.n_quads - 1)

    sph = scene.spheres
    c = sph.center[sid] + time[:, None] * sph.velocity[sid]
    r = sph.radius[sid]
    # times the reciprocal, as the replay tiers and K3/K2 compute it
    outward_s = (p - c) * (1.0 / torch.where(r > 0, r, 1.0))[:, None]
    # θ = atan2(√(x²+z²), -y), equal to acos(-y) on the unit sphere but
    # with finite gradients at the poles; the sqrt is guarded at x = z = 0,
    # and so is atan2(-z, x), whose gradient at (0, 0) is NaN
    sx, sy, sz = outward_s[:, 0], outward_s[:, 1], outward_s[:, 2]
    rxz = vm.safe_sqrt(sx * sx + sz * sz)
    theta = atan2_rn(rxz, -sy)
    x_safe = torch.where(rxz > 0, sx, 1.0)
    phi = atan2_rn(-sz, x_safe) + torch.pi
    u_s = phi / (2.0 * torch.pi)
    v_s = theta / torch.pi

    normal_all, _, w_all, _ = quad_plane_basis(scene.quads)
    planar = p - scene.quads.q[qid]
    alpha = vm.dot(w_all[qid], vm.cross(planar, scene.quads.v[qid]))
    beta = vm.dot(w_all[qid], vm.cross(scene.quads.u[qid], planar))

    outward = torch.where(is_quad[:, None], normal_all[qid], outward_s)
    mat_id = torch.where(is_quad, scene.quads.mat_id[qid], sph.mat_id[sid])
    normal, front_face = vm.set_face_normal(d, outward)
    return HitBatch(valid=valid, t=torch.where(valid, t, BIG), p=p, normal=normal,
                    front_face=front_face, u=torch.where(is_quad, alpha, u_s),
                    v=torch.where(is_quad, beta, v_s), mat_id=mat_id,
                    prim_id=torch.where(valid, prim_id.to(torch.int32), -1))


def closest_hit_brute(scene: Scene, o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                      t_min=T_MIN, t_max=BIG) -> HitBatch:
    """Brute-force closest hit: candidate t over every primitive, then the
    argmin (the lowest index among equal minima)."""
    all_t = torch.cat([sphere_ts(scene, o, d, time, t_min, t_max),
                       quad_ts(scene, o, d, t_min, t_max)], dim=1)
    best = torch.argmin(all_t, dim=1)
    t = torch.gather(all_t, 1, best[:, None])[:, 0]
    return hit_attributes(scene, o, d, time, t, best.to(torch.int32))
