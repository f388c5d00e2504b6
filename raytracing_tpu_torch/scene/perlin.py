"""Perlin gradient noise and the marble texture, the counterpart of
``raytracing_tpu.scene.perlin``: the tables are drawn on the host from the
same seeded numpy stream, so both packages hold equal tables, and the
evaluation is the same XOR-hash lattice scheme vectorised over points:
8 corner gathers and a Hermite-smoothed trilinear blend of
``dot(gradient, offset)``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve
from .types import PerlinTables

POINT_COUNT = 256


def make_tables(seed: int = 0, device=DEFAULT_DEVICE) -> PerlinTables:
    """Gradient vectors (normalised uniform-cube samples) and three
    Fisher–Yates permutations from ``np.random.default_rng(seed)``."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, size=(POINT_COUNT, 3))
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    v = np.where(norms < 1e-12, 1.0, v / np.maximum(norms, 1e-12))
    perms = [rng.permutation(POINT_COUNT).astype(np.int32) for _ in range(3)]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PerlinTables(randvec=t(v.astype(np.float32)), perm_x=t(perms[0]),
                        perm_y=t(perms[1]), perm_z=t(perms[2]))


def noise(tables: PerlinTables, p: torch.Tensor) -> torch.Tensor:
    """Gradient noise in [-1, 1] at points ``p`` (..., 3)."""
    pf = torch.floor(p)
    uvw = p - pf                 # fractional cell coordinates
    ijk = pf.to(torch.int32)     # lattice cell
    hermite = uvw * uvw * (3.0 - 2.0 * uvw)
    hx0, hy0, hz0 = hermite[..., 0], hermite[..., 1], hermite[..., 2]
    ux, uy, uz = uvw[..., 0], uvw[..., 1], uvw[..., 2]

    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                # `& 255` on int32 wraps negative cells as C does
                hx = tables.perm_x[((ijk[..., 0] + di) & 255).long()]
                hy = tables.perm_y[((ijk[..., 1] + dj) & 255).long()]
                hz = tables.perm_z[((ijk[..., 2] + dk) & 255).long()]
                g = tables.randvec[(hx ^ hy ^ hz).long()]  # (..., 3) corner gradient
                s = g[..., 0] * (ux - di) + g[..., 1] * (uy - dj) + g[..., 2] * (uz - dk)
                wx = di * hx0 + (1 - di) * (1.0 - hx0)
                wy = dj * hy0 + (1 - dj) * (1.0 - hy0)
                wz = dk * hz0 + (1 - dk) * (1.0 - hz0)
                accum = accum + wx * wy * wz * s
    return accum


def turbulence(tables: PerlinTables, p: torch.Tensor, depth: int = 7) -> torch.Tensor:
    """|Σ 2^-k noise(2^k p)| over ``depth`` octaves."""
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    temp_p = p
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * noise(tables, temp_p)
        weight *= 0.5
        temp_p = temp_p * 2.0
    return torch.abs(accum)


def marble(tables: PerlinTables, p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The marble texture's scalar field 0.5·(1 + sin(scale·z + 10·turb(p)))."""
    return 0.5 * (1.0 + torch.sin(scale * p[..., 2] + 10.0 * turbulence(tables, p, 7)))
