"""Packed-table decision replay, the counterpart of
``raytracing_tpu.diff.replay_fast``.

Every per-primitive quantity the replay's bounce math reads is packed
into one ``(L, N_FIELDS)`` f32 table, one row per global scene id
(spheres, then quads), built with autograd from the scene's tensors: a
cotangent on the table flows back to sphere centers, velocities and
radii, quad corners and edges, material fuzz and ior, and texture rgbs.
The replay kernels (``diff/replay_kernel.py``) read the rows of the
recorded winner ids.

:func:`replay_trace_fast` is the pure-PyTorch replay on the same table:
one :func:`table_lookup <raytracing_tpu_torch.ops.table_gather.table_lookup>`
per bounce (K4 on the card, whose backward is the fold kernel) and the
bounce math on scalarized ``(B,)`` state, with autograd to the scene and
to the rays (so to the camera). It mirrors ``render/integrator.py``
``_bounce_once`` op for op (the same helper formulas written per
component, the same RNG streams), so its radiance and segments equal
``diff/replay.py`` ``replay_trace``'s bit for bit. It covers solid and
one-level checker-of-solid textures (:func:`supported_fast`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.vecmath import NEAR_ZERO_EPS
from ..ops.intersect import BIG, PARALLEL_EPS, T_MIN, quad_plane_basis, safe_sqrt_rn
from ..ops.scatter import schlick_reflectance
from ..ops.table_gather import table_lookup
from ..render.integrator import run_bounce
from ..scene.types import (MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_METAL, TEX_CHECKER,
                           TEX_SOLID, Scene, refuse_media)

# packed field slots
_F_ISQUAD = 0
_F_G0 = 1      # center | q          (3)
_F_G1 = 4      # velocity | u edge   (3)
_F_RAD = 7     # radius | 0
_F_QN = 8      # 0 | unit normal     (3)
_F_QD = 11     # 0 | plane D
_F_MTYPE = 12
_F_FUZZ = 13
_F_IOR = 14    # 1.0 for non-dielectrics (keeps masked branches finite)
_F_ISCHK = 15
_F_RGB_E = 16  # even-child / solid rgb (3)
_F_RGB_O = 19  # odd-child rgb          (3)
_F_INVSC = 22  # checker inv_scale
N_FIELDS = 23


def supported_fast(scene: Scene) -> bool:
    """The replay covers solid and one-level checker-of-solids textures."""
    tt = scene.textures.ttype.detach().cpu().numpy()
    if not np.all((tt == TEX_SOLID) | (tt == TEX_CHECKER)):
        return False
    kids = scene.textures.child.detach().cpu().numpy()[tt == TEX_CHECKER].reshape(-1)
    return bool(np.all(tt[kids] == TEX_SOLID)) if kids.size else True


def table_rows(n_primitives: int) -> int:
    """L: rows of the packed table, the primitives padded to a multiple of 128."""
    return max(128, -(-n_primitives // 128) * 128)


def build_replay_table(scene: Scene) -> torch.Tensor:
    """``(L, N_FIELDS)`` f32 packed per-global-primitive table on the
    scene's device, differentiable in the scene's float tensors. Padding
    rows are zero except ior = 1. Refuses a scene with media, which no
    replay traces."""
    refuse_media(scene, "the gradient replay")
    sph, qd = scene.spheres, scene.quads
    mats, tex = scene.materials, scene.textures
    n_sph, n_quad = scene.n_spheres, scene.n_quads
    n = n_sph + n_quad
    dev = sph.center.device
    f32 = torch.float32

    def mat_cols(mat_id):
        mat_id = mat_id.long()
        mt = mats.mtype[mat_id]
        ior = torch.where(mt == MAT_DIELECTRIC, mats.ior[mat_id], 1.0)
        tid = mats.tex_id[mat_id].long()
        is_chk = tex.ttype[tid] == TEX_CHECKER
        even = torch.where(is_chk, tex.child[tid, 0].long(), tid)
        odd = torch.where(is_chk, tex.child[tid, 1].long(), tid)
        return [mt.to(f32)[:, None], mats.fuzz[mat_id][:, None], ior[:, None],
                is_chk.to(f32)[:, None], tex.rgb[even], tex.rgb[odd],
                torch.where(is_chk, tex.scale[tid], 0.0)[:, None]]

    def zeros(m, k):
        return torch.zeros((m, k), dtype=f32, device=dev)

    rows_s = torch.cat([zeros(n_sph, 1), sph.center, sph.velocity, sph.radius[:, None],
                        zeros(n_sph, 4), *mat_cols(sph.mat_id)], dim=1)
    parts = [rows_s]
    if n_quad > 0:
        normal, dconst, _, _ = quad_plane_basis(qd)
        parts.append(torch.cat([torch.ones((n_quad, 1), dtype=f32, device=dev), qd.q, qd.u,
                                zeros(n_quad, 1), normal, dconst[:, None],
                                *mat_cols(qd.mat_id)], dim=1))
    pad = zeros(table_rows(n) - n, N_FIELDS)
    pad[:, _F_IOR] = 1.0  # keeps masked dielectric math finite
    parts.append(pad)
    return torch.cat(parts, dim=0)


def replay_trace_fast(scene: Scene, ids: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                      time: torch.Tensor, pixel_ids: torch.Tensor, sample_ids: torch.Tensor,
                      background, max_depth: int, seed, remat: bool = True, active0=None):
    """Replay the recorded ``ids (max_depth, B) i32`` (global ids, -1 =
    miss) from the packed table: ``(radiance (B, 3), segments)``,
    ``segments`` a Python int, equal to ``diff/replay.py`` ``replay_trace``.
    Differentiable in the scene's tensors and in ``o``, ``d`` and ``time``.
    ``remat`` checkpoints each bounce (the backward recomputes it, and
    its table lookup, instead of storing its temporaries)."""
    B = o.shape[0]
    bg_r, bg_g, bg_b = (float(x) for x in background)
    table = build_replay_table(scene)
    n_sph = scene.n_spheres
    has_moving = scene.flags.has_moving
    two_pi = 2.0 * math.pi
    zeros = torch.zeros(B, dtype=torch.float32, device=o.device)
    ones = torch.ones(B, dtype=torch.float32, device=o.device)
    act0 = (torch.ones(B, dtype=torch.bool, device=o.device) if active0 is None
            else active0.to(torch.bool))
    st = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
          zeros, zeros, zeros, ones, ones, ones, act0,
          torch.zeros((), dtype=torch.int64, device=o.device))

    def body(st, bounce, ids_b):
        (ox, oy, oz, dx, dy, dz, rr, rg, rb, tr, tg, tb, active, segments) = st
        pid = torch.where(ids_b >= 0, ids_b, 0)
        v = table_lookup(table, pid).unbind(0)
        is_quad = pid >= n_sph  # row order is the global id order

        # winner t (diff/replay.py winner_t, op for op)
        cx, cy, cz = v[_F_G0], v[_F_G0 + 1], v[_F_G0 + 2]
        if has_moving:
            cx = cx + time * v[_F_G1]
            cy = cy + time * v[_F_G1 + 1]
            cz = cz + time * v[_F_G1 + 2]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        a = dx * dx + dy * dy + dz * dz
        half_b = ocx * dx + ocy * dy + ocz * dz
        r = v[_F_RAD]
        cq = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r
        disc = half_b * half_b - a * cq
        sqrtd = safe_sqrt_rn(disc)
        root0 = (-half_b - sqrtd) / a
        root1 = (-half_b + sqrtd) / a
        t_s = torch.where(root0 > T_MIN, root0, root1)
        qnx, qny, qnz = v[_F_QN], v[_F_QN + 1], v[_F_QN + 2]
        denom = qnx * dx + qny * dy + qnz * dz
        safe_denom = torch.where(torch.abs(denom) < PARALLEL_EPS, 1.0, denom)
        t_q = (v[_F_QD] - (qnx * ox + qny * oy + qnz * oz)) / safe_denom
        t = torch.where(is_quad, t_q, t_s)
        t = torch.where(ids_b >= 0, t, BIG)

        # hit attributes (ops/intersect.py hit_attributes)
        valid = torch.isfinite(t)
        t_safe = torch.where(valid, t, 0.0)
        px = ox + t_safe * dx
        py = oy + t_safe * dy
        pz = oz + t_safe * dz
        inv_r = 1.0 / torch.where(r > 0, r, 1.0)
        owx = torch.where(is_quad, qnx, (px - cx) * inv_r)
        owy = torch.where(is_quad, qny, (py - cy) * inv_r)
        owz = torch.where(is_quad, qnz, (pz - cz) * inv_r)
        front = (dx * owx + dy * owy + dz * owz) < 0.0
        nx = torch.where(front, owx, -owx)
        ny = torch.where(front, owy, -owy)
        nz = torch.where(front, owz, -owz)

        # texture: solid rgb or the checker's parity-selected child rgb
        inv_sc = v[_F_INVSC]
        cells = (torch.floor(inv_sc * px).to(torch.int32)
                 + torch.floor(inv_sc * py).to(torch.int32)
                 + torch.floor(inv_sc * pz).to(torch.int32))
        use_even = ((cells % 2) == 0) | (v[_F_ISCHK] == 0.0)
        tex_r = torch.where(use_even, v[_F_RGB_E], v[_F_RGB_O])
        tex_g = torch.where(use_even, v[_F_RGB_E + 1], v[_F_RGB_O + 1])
        tex_b = torch.where(use_even, v[_F_RGB_E + 2], v[_F_RGB_O + 2])

        # scatter and emit (ops/scatter.py scatter_and_emit)
        u4 = rng_mod.uniform4(pixel_ids, sample_ids,
                              bounce * rng_mod.N_STREAMS + rng_mod.STREAM_SCATTER, seed)
        zdir = 1.0 - 2.0 * u4[:, 0]  # core/rng.py unit_vector
        rho = torch.sqrt(torch.clamp(1.0 - zdir * zdir, min=0.0))
        phi = two_pi * u4[:, 1]
        rux, ruy, ruz = rho * torch.cos(phi), rho * torch.sin(phi), zdir

        ldx, ldy, ldz = nx + rux, ny + ruy, nz + ruz  # lambertian
        degen = ((torch.abs(ldx) < NEAR_ZERO_EPS) & (torch.abs(ldy) < NEAR_ZERO_EPS)
                 & (torch.abs(ldz) < NEAR_ZERO_EPS))
        ldx = torch.where(degen, nx, ldx)
        ldy = torch.where(degen, ny, ldy)
        ldz = torch.where(degen, nz, ldz)

        d_dot_n = dx * nx + dy * ny + dz * nz  # metal
        rfx = dx - 2.0 * d_dot_n * nx
        rfy = dy - 2.0 * d_dot_n * ny
        rfz = dz - 2.0 * d_dot_n * nz
        rlen = torch.sqrt(rfx * rfx + rfy * rfy + rfz * rfz)
        fuzz = v[_F_FUZZ]
        mdx = rfx / rlen + fuzz * rux
        mdy = rfy / rlen + fuzz * ruy
        mdz = rfz / rlen + fuzz * ruz
        metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0

        ior = v[_F_IOR]  # dielectric, vecmath.refract's guard mirrored
        ri = torch.where(front, 1.0 / ior, ior)
        dlen = torch.sqrt(dx * dx + dy * dy + dz * dz)
        udx, udy, udz = dx / dlen, dy / dlen, dz / dlen
        cos_t = torch.clamp(-(udx * nx + udy * ny + udz * nz), max=1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        use_reflect = (ri * sin_t > 1.0) | (schlick_reflectance(cos_t, ri) > u4[:, 2])
        ppx = ri * (udx + cos_t * nx)
        ppy = ri * (udy + cos_t * ny)
        ppz = ri * (udz + cos_t * nz)
        k = torch.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz))
        k_pos = k > 0.0
        kroot = torch.where(k_pos, torch.sqrt(torch.where(k_pos, k, 1.0)), 0.0)
        u_dot_n = udx * nx + udy * ny + udz * nz
        gdx = torch.where(use_reflect, udx - 2.0 * u_dot_n * nx, ppx - kroot * nx)
        gdy = torch.where(use_reflect, udy - 2.0 * u_dot_n * ny, ppy - kroot * ny)
        gdz = torch.where(use_reflect, udz - 2.0 * u_dot_n * nz, ppz - kroot * nz)

        mtype = v[_F_MTYPE].to(torch.int32)
        is_metal = mtype == MAT_METAL
        is_diel = mtype == MAT_DIELECTRIC
        is_light = mtype == MAT_DIFFUSE_LIGHT
        ndx = torch.where(is_diel, gdx, torch.where(is_metal, mdx, ldx))
        ndy = torch.where(is_diel, gdy, torch.where(is_metal, mdy, ldy))
        ndz = torch.where(is_diel, gdz, torch.where(is_metal, mdz, ldz))
        did_scatter = torch.where(is_metal, metal_ok, True) & ~is_light

        # bounce bookkeeping (render/integrator.py _bounce_once)
        miss = active & ~valid
        rr = rr + torch.where(miss, tr * bg_r, 0.0)
        rg = rg + torch.where(miss, tg * bg_g, 0.0)
        rb = rb + torch.where(miss, tb * bg_b, 0.0)
        hit_mask = active & valid
        emit = hit_mask & is_light
        rr = rr + torch.where(emit, tr * tex_r, 0.0)
        rg = rg + torch.where(emit, tg * tex_g, 0.0)
        rb = rb + torch.where(emit, tb * tex_b, 0.0)
        live = hit_mask & did_scatter
        tr = torch.where(live, tr * torch.where(is_diel, 1.0, tex_r), tr)
        tg = torch.where(live, tg * torch.where(is_diel, 1.0, tex_g), tg)
        tb = torch.where(live, tb * torch.where(is_diel, 1.0, tex_b), tb)
        return (torch.where(live, px, ox), torch.where(live, py, oy), torch.where(live, pz, oz),
                torch.where(live, ndx, dx), torch.where(live, ndy, dy),
                torch.where(live, ndz, dz), rr, rg, rb, tr, tg, tb, live,
                segments + active.sum())

    for bounce in range(max_depth):
        st = run_bounce(lambda s, b=bounce: body(s, b, ids[b]), st, remat)
    return torch.stack([st[6], st[7], st[8]], dim=-1), int(st[13])
