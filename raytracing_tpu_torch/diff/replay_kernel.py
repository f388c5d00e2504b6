"""Decision replay, forward and backward: the counterpart of
``raytracing_tpu.diff.replay_kernel``.

Given the winner ids a decision pass recorded (``trace_megakernel(...,
want_ids=...)``), the replay re-runs each ray's bounce chain from the
packed table (``diff/replay_fast.build_replay_table``) without searching
for hits, so it is differentiable in the table. Two kernels carry it:

* **K3** (``replay_fwd``): the replay forward, radiance and bounce
  counts. It replaces the Pallas ``make_replay_kernels`` ``fwd_kernel``.
* **K2** (``replay_bwd``): the forward again, stashing each bounce's
  entry state in that bounce's rows of its own output, then the
  hand-derived reverse sweep (``bounce_bwd`` in the JAX package) giving the
  per-(bounce, ray) cotangents of the NG = 19 differentiable table fields,
  ``(D, NG, n)``, for a replay of any depth D. It replaces ``bwd_kernel``.

Both are CUDA C++ (``csrc/replay_kernel.cu``): K2 one thread per ray, K3
persistent warps whose lanes take a new ray as theirs ends
(:func:`replay_fwd_probe` also runs K3's earlier one-thread-per-ray design
and counts the lanes a warp keeps busy). Beside
them are plain PyTorch versions: :func:`replay_fwd_torch`, the bounce
chain vectorised over rays, and :func:`replay_bwd_torch`, which gets the
same cotangents by autograd through it (each bounce's gathered rows are a
leaf), so the kernel's hand-derived VJP is checked against autodiff. The
wrappers run the plain versions for CPU tensors and launch the kernels for
CUDA tensors, or raise.

Gating: bounces ``b >= maxlen[tile]`` of a 1024-ray tile are skipped (a
bounce whose every ray is dead is the identity), as the Pallas kernels'
``pl.when(b < ml)`` does; per-ray recorded lengths would not do, since a
replay can keep a ray alive past its recorded length where an ulp flips a
Schlick or metal-absorb decision.

On top: :func:`replay_trace_kernel` (an autograd function, K3 forward, K2
backward) and :func:`replay_grads_sorted`, the explicit-cotangent
gradient pass of the fwd+bwd bench: rays sorted by recorded length, K2,
and the per-bounce table-gradient reduction over planned prefixes.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import _kernels
from ..core import rng as rng_mod
from ..core.vecmath import NEAR_ZERO_EPS
from ..ops.intersect import PARALLEL_EPS, T_MIN
from ..ops.table_gather import fold
from ..scene.types import MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_METAL
from ..utils.profiling import stage
from . import replay_fast as rf

TILE = 1024      # rays per gating tile, in the kernels' ray order

# ray_f rows of the replay kernels' ray state
RX, RY, RZ, RDX, RDY, RDZ, RTM, RACT = range(8)
N_RAY_F = 8

# gradient output field order (NG cotangents per bounce per ray)
_G_C = 0      # center / q           (3)
_G_V = 3      # velocity (3; the quad u edge gets none)
_G_R = 6      # radius
_G_QN = 7     # quad unit normal     (3)
_G_QD = 10    # quad plane D
_G_FUZZ = 11
_G_IOR = 12
_G_ER = 13    # even rgb (3)
_G_OR = 16    # odd rgb  (3)
NG = 19

# packed-table column → gradient slot
_TABLE_GRAD_COLS = (
    (rf._F_G0, _G_C), (rf._F_G0 + 1, _G_C + 1), (rf._F_G0 + 2, _G_C + 2),
    (rf._F_G1, _G_V), (rf._F_G1 + 1, _G_V + 1), (rf._F_G1 + 2, _G_V + 2),
    (rf._F_RAD, _G_R),
    (rf._F_QN, _G_QN), (rf._F_QN + 1, _G_QN + 1), (rf._F_QN + 2, _G_QN + 2),
    (rf._F_QD, _G_QD),
    (rf._F_FUZZ, _G_FUZZ), (rf._F_IOR, _G_IOR),
    (rf._F_RGB_E, _G_ER), (rf._F_RGB_E + 1, _G_ER + 1), (rf._F_RGB_E + 2, _G_ER + 2),
    (rf._F_RGB_O, _G_OR), (rf._F_RGB_O + 1, _G_OR + 1), (rf._F_RGB_O + 2, _G_OR + 2),
)
_TCOLS = [tc for tc, _ in _TABLE_GRAD_COLS]
_GSLOTS = [gs for _, gs in _TABLE_GRAD_COLS]


def _copy_runs(pairs):
    """``(table column, gradient slot, n)`` runs of consecutive pairs: the
    map as slices, so copying it needs no index tensor on the device (a
    list index is copied from the host, which a captured graph cannot)."""
    runs = []
    for tc, gs in pairs:
        if runs and runs[-1][0] + runs[-1][2] == tc and runs[-1][1] + runs[-1][2] == gs:
            runs[-1][2] += 1
        else:
            runs.append([tc, gs, 1])
    return tuple(tuple(r) for r in runs)


_COPY_RUNS = _copy_runs(_TABLE_GRAD_COLS)

fwd_launches = _kernels.LaunchCount()  # K3 kernel launches (plain-version calls excluded)
bwd_launches = _kernels.LaunchCount()  # K2 kernel launches (plain-version calls excluded)
camera_launches = _kernels.LaunchCount()  # rt_camera_rays launches (plain-version calls excluded)


def plan_prefixes(length_hist, B, max_depth, margin=1.15):
    """Static per-bounce ray-prefix plan for :func:`replay_grads_sorted`.

    ``length_hist``: (max_depth + 1,) counts of recorded path lengths.
    Bounce ``b`` touches exactly the rays with length > b; with rays
    length-sorted those are a prefix of ``n_b = sum(hist[b+1:])`` rays.
    Returns D ints, ``ceil(margin · n_b)`` rounded up to a TILE multiple
    and clamped to B. ``replay_grads_sorted`` flags (``ok`` False) a plan
    that a bounce's real count exceeded."""
    hist = np.asarray(length_hist, np.int64)
    return tuple(min(B, -(-int(np.ceil(int(hist[b + 1:].sum()) * margin)) // TILE) * TILE)
                 for b in range(max_depth))


def tile_maxlen(lengths: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Per-TILE maximum of the recorded lengths (the gating bound), i32."""
    n = lengths.shape[0]
    pad = -n % TILE
    lp = torch.nn.functional.pad(lengths.to(torch.int32), (0, pad))
    return lp.reshape(-1, TILE).amax(dim=1).clamp(max=max_depth).to(torch.int32)


def pack_replay_rays(o, d, time, active0=None):
    """Rays → the replay kernels' ``ray_f (N_RAY_F, B)`` f32 (origin,
    direction, time, alive flag)."""
    B = o.shape[0]
    ray_f = torch.empty((N_RAY_F, B), dtype=torch.float32, device=o.device)
    ray_f[RX:RZ + 1] = o.T
    ray_f[RDX:RDZ + 1] = d.T
    ray_f[RTM] = time
    ray_f[RACT] = 1.0 if active0 is None else active0.to(torch.float32)
    return ray_f


def replay_rays(camera, ray_i: torch.Tensor, alive: torch.Tensor, seed: int) -> torch.Tensor:
    """The replay kernels' ``ray_f (N_RAY_F, n)`` of the camera rays of
    ``ray_i (2, n) i32`` (rows pix, smp), alive where ``alive (n,) bool``
    is, from ``camera`` (a ``render.camera.CameraStart``): bit for bit
    ``pack_replay_rays(*camera.rays(pix, smp, seed), alive)``, which CPU
    tensors run. On CUDA tensors it is one launch of ``rt_camera_rays``
    (``csrc/camera_rays.cu``), which adds one to :data:`camera_launches`."""
    if ray_i.dim() != 2 or ray_i.shape[0] != 2 or ray_i.dtype != torch.int32:
        raise ValueError(f"ray_i must be (2, n) int32, got {tuple(ray_i.shape)} {ray_i.dtype}")
    n = ray_i.shape[1]
    if alive.shape != (n,) or alive.dtype != torch.bool:
        raise ValueError(f"alive must be ({n},) bool, got {tuple(alive.shape)} {alive.dtype}")
    dev = ray_i.device
    camera.check(dev)
    if alive.device != dev:
        raise ValueError("ray_i and alive must be on one device")
    if dev.type == "cpu":
        return pack_replay_rays(*camera.rays(ray_i[0], ray_i[1], seed), alive)
    if dev.type != "cuda":
        raise ValueError(f"rt_camera_rays runs on CUDA tensors (kernel) or CPU tensors (plain "
                         f"version), not {dev}")
    if not (ray_i.is_contiguous() and alive.is_contiguous()):
        raise ValueError("rt_camera_rays needs contiguous tensors")
    if n * N_RAY_F >= 2 ** 31:
        raise ValueError(f"rt_camera_rays launch of {n} rays exceeds its 32-bit indexing")
    out = torch.empty((N_RAY_F, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _kernels.library().lib
    with torch.cuda.device(dev):
        err = lib.rt_camera_rays(ray_i.data_ptr(), alive.data_ptr(), n, camera.camera.data_ptr(),
                                 camera.width, camera.flags, ctypes.c_uint32(seed),
                                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    camera_launches.add(dev)
    if err != 0:
        raise RuntimeError(f"rt_camera_rays launch failed: {lib.rt_error_string(err).decode()}")
    return out


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

def _check(table, ids, ray_f, ray_i, maxlen, extra=()):
    n = ray_f.shape[1]
    D = ids.shape[0]
    if table.dim() != 2 or table.shape[1] != rf.N_FIELDS or table.dtype != torch.float32:
        raise ValueError(f"table must be (L, {rf.N_FIELDS}) float32, got {tuple(table.shape)}")
    if ids.shape != (D, n) or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (D, {n}) int32, got {tuple(ids.shape)} {ids.dtype}")
    if ray_f.shape != (N_RAY_F, n) or ray_f.dtype != torch.float32:
        raise ValueError(f"ray_f must be ({N_RAY_F}, n) float32, got {tuple(ray_f.shape)}")
    if ray_i.shape != (2, n) or ray_i.dtype != torch.int32:
        raise ValueError(f"ray_i must be (2, n) int32, got {tuple(ray_i.shape)} {ray_i.dtype}")
    if maxlen.shape != (-(-n // TILE),) or maxlen.dtype != torch.int32:
        raise ValueError(f"maxlen must be ({-(-n // TILE)},) int32, got {tuple(maxlen.shape)}")
    dev = ray_f.device
    tensors = (table, ids, ray_f, ray_i, maxlen, *extra)
    if any(t.device != dev for t in tensors):
        raise ValueError("replay inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the replay kernels run on CUDA tensors (kernel) or CPU tensors "
                         f"(plain version), not {dev}")
    if dev.type == "cuda":
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the replay kernels need contiguous tensors")
        # the kernels index the ray rows in 32 bits, (D, n) and (D, NG, n) in 64
        if n * N_RAY_F >= 2 ** 31:
            raise ValueError(f"replay launch of {n} rays exceeds the ray rows' 32-bit indexing")
    return n, D, dev


def replay_fwd(table, ids, ray_f, ray_i, maxlen, *, seed: int, n_sph: int,
               has_moving: bool, background):
    """K3: replay forward. ``table (L, N_FIELDS)``, ``ids (D, n) i32``
    (global ids, -1 = miss), ``ray_f (N_RAY_F, n)``, ``ray_i (2, n) i32``
    (pix, smp), ``maxlen (ceil(n/TILE),) i32``. Returns ``(rad (3, n),
    bounces (n,) i32)``."""
    n, D, dev = _check(table, ids, ray_f, ray_i, maxlen)
    if dev.type == "cpu":
        return replay_fwd_torch(table, ids, ray_f, ray_i, maxlen, seed=seed, n_sph=n_sph,
                                has_moving=has_moving, background=background)
    lib = _kernels.library().lib
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    bc = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return rad, bc
    with torch.cuda.device(dev):
        nxt = torch.zeros((1,), dtype=torch.int32, device=dev)  # the lanes' ray counter
        err = lib.rt_replay_fwd(
            table.data_ptr(), ids.data_ptr(), ray_f.data_ptr(), ray_i.data_ptr(),
            maxlen.data_ptr(), n, D, n_sph, int(has_moving), ctypes.c_uint32(seed),
            *(float(x) for x in background), rad.data_ptr(), bc.data_ptr(), nxt.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    fwd_launches.add(dev)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: {lib.rt_error_string(err).decode()}")
    return rad, bc


K3_DESIGNS = ("baseline", "refill")  # K3 before and since its lanes refill


def replay_fwd_probe(table, ids, ray_f, ray_i, maxlen, *, seed: int, n_sph: int,
                     has_moving: bool, background, design: str = "refill",
                     count: bool = False):
    """K3's measurement probe (CUDA tensors only; not counted in
    :data:`fwd_launches`): K3 in ``design`` ``"refill"`` (K3 itself) or
    ``"baseline"`` (one thread per ray, a warp running until its longest
    ray ends, the design before), with the same outputs as
    :func:`replay_fwd`. ``count`` runs the counting instantiation and
    returns ``(rad, bounces, dict(bounces=, issues=))``: the bounces run
    (lanes summed over issues) and the bounce issues (one per warp and
    bounce), so ``bounces / (32 * issues)`` is the share of a warp's lanes
    busy at a bounce; else ``(rad, bounces, None)``."""
    n, D, dev = _check(table, ids, ray_f, ray_i, maxlen)
    if dev.type != "cuda" or design not in K3_DESIGNS:
        raise ValueError(f"K3's probe runs on CUDA tensors in a design of {K3_DESIGNS}")
    lib = _kernels.library().lib
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    bc = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        nxt = torch.zeros((1,), dtype=torch.int32, device=dev)
        stats = torch.zeros((2,), dtype=torch.int64, device=dev) if count else None
        err = lib.rt_replay_fwd_probe(
            table.data_ptr(), ids.data_ptr(), ray_f.data_ptr(), ray_i.data_ptr(),
            maxlen.data_ptr(), n, D, n_sph, int(has_moving), ctypes.c_uint32(seed),
            *(float(x) for x in background), rad.data_ptr(), bc.data_ptr(), nxt.data_ptr(),
            int(design == "refill"), None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 probe launch failed: {lib.rt_error_string(err).decode()}")
    if stats is None:
        return rad, bc, None
    bounces, issues = (int(x) for x in stats.cpu())
    return rad, bc, dict(bounces=bounces, issues=issues)


def replay_bwd(table, ids, ray_f, ray_i, rad_bar, maxlen, *, seed: int, n_sph: int,
               has_moving: bool, background):
    """K2: per-(bounce, ray) cotangents ``(D, NG, n)`` of the table fields
    for the radiance cotangent ``rad_bar (3, n)``; zero for the bounces a
    ray did not run. Inputs as :func:`replay_fwd`."""
    n, D, dev = _check(table, ids, ray_f, ray_i, maxlen, (rad_bar,))
    if rad_bar.shape != (3, n) or rad_bar.dtype != torch.float32:
        raise ValueError(f"rad_bar must be (3, {n}) float32, got {tuple(rad_bar.shape)}")
    if dev.type == "cpu":
        return replay_bwd_torch(table, ids, ray_f, ray_i, rad_bar, maxlen, seed=seed,
                                n_sph=n_sph, has_moving=has_moving, background=background)
    lib = _kernels.library().lib
    g = torch.empty((D, NG, n), dtype=torch.float32, device=dev)
    if n == 0:
        return g
    with torch.cuda.device(dev):
        err = lib.rt_replay_bwd(
            table.data_ptr(), ids.data_ptr(), ray_f.data_ptr(), ray_i.data_ptr(),
            maxlen.data_ptr(), rad_bar.data_ptr(), n, D, n_sph, int(has_moving),
            ctypes.c_uint32(seed), *(float(x) for x in background), g.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    bwd_launches.add(dev)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: {lib.rt_error_string(err).decode()}")
    return g


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _bounce(v, has_id, pid, st, tm, pix, smp, seed, b, n_sph, has_moving, bg):
    """One replay bounce for every ray, the JAX ``bounce_fwd`` op for op.
    ``v``: the rays' table rows ``(n, N_FIELDS)``; ``st``: (ox, oy, oz,
    dx, dy, dz, rr, rg, rb, tr, tg, tb, active). Returns the new state."""
    ox, oy, oz, dx, dy, dz, rr, rg, rb, tr, tg, tb, act = st
    f = v.unbind(1)
    is_quad = pid >= n_sph

    cx, cy, cz = f[rf._F_G0], f[rf._F_G0 + 1], f[rf._F_G0 + 2]
    if has_moving:
        cx = cx + tm * f[rf._F_G1]
        cy = cy + tm * f[rf._F_G1 + 1]
        cz = cz + tm * f[rf._F_G1 + 2]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    hb = ocx * dx + ocy * dy + ocz * dz
    r = f[rf._F_RAD]
    cq = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r
    disc = hb * hb - a * cq
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    root0 = (-hb - sq) / a
    root1 = (-hb + sq) / a
    t_s = torch.where(root0 > T_MIN, root0, root1)

    qnx, qny, qnz = f[rf._F_QN], f[rf._F_QN + 1], f[rf._F_QN + 2]
    den = qnx * dx + qny * dy + qnz * dz
    sden = torch.where(torch.abs(den) < PARALLEL_EPS, 1.0, den)
    t_q = (f[rf._F_QD] - (qnx * ox + qny * oy + qnz * oz)) / sden

    ts_ = torch.where(has_id, torch.where(is_quad, t_q, t_s), 0.0)
    px = ox + ts_ * dx
    py = oy + ts_ * dy
    pz = oz + ts_ * dz
    inv_r = 1.0 / torch.where(r > 0, r, 1.0)
    owx = torch.where(is_quad, qnx, (px - cx) * inv_r)
    owy = torch.where(is_quad, qny, (py - cy) * inv_r)
    owz = torch.where(is_quad, qnz, (pz - cz) * inv_r)
    front = (dx * owx + dy * owy + dz * owz) < 0.0
    sgn = torch.where(front, 1.0, -1.0)
    nx, ny, nz = sgn * owx, sgn * owy, sgn * owz

    inv_sc = f[rf._F_INVSC]
    cells = (torch.floor(inv_sc * px).to(torch.int32) + torch.floor(inv_sc * py).to(torch.int32)
             + torch.floor(inv_sc * pz).to(torch.int32))
    use_even = ((cells & 1) == 0) | (f[rf._F_ISCHK] == 0.0)
    tex_r = torch.where(use_even, f[rf._F_RGB_E], f[rf._F_RGB_O])
    tex_g = torch.where(use_even, f[rf._F_RGB_E + 1], f[rf._F_RGB_O + 1])
    tex_b = torch.where(use_even, f[rf._F_RGB_E + 2], f[rf._F_RGB_O + 2])

    ctr = torch.full_like(pix, b * rng_mod.N_STREAMS + rng_mod.STREAM_SCATTER, dtype=torch.int64)
    w0, w1, w2, _ = rng_mod.pcg4d(pix, smp, ctr, torch.full_like(ctr, seed))
    u0, u1, u2 = rng_mod.to_unit_float(w0), rng_mod.to_unit_float(w1), rng_mod.to_unit_float(w2)
    zdir = 1.0 - 2.0 * u0
    rho = torch.sqrt(torch.clamp(1.0 - zdir * zdir, min=0.0))
    phi = (2.0 * math.pi) * u1
    rux = rho * torch.cos(phi)
    ruy = rho * torch.sin(phi)
    ruz = zdir

    ldx0, ldy0, ldz0 = nx + rux, ny + ruy, nz + ruz
    degen = ((torch.abs(ldx0) < NEAR_ZERO_EPS) & (torch.abs(ldy0) < NEAR_ZERO_EPS)
             & (torch.abs(ldz0) < NEAR_ZERO_EPS))
    ldx = torch.where(degen, nx, ldx0)
    ldy = torch.where(degen, ny, ldy0)
    ldz = torch.where(degen, nz, ldz0)

    ddn = dx * nx + dy * ny + dz * nz
    rfx = dx - 2.0 * ddn * nx
    rfy = dy - 2.0 * ddn * ny
    rfz = dz - 2.0 * ddn * nz
    rlen = torch.sqrt(rfx * rfx + rfy * rfy + rfz * rfz)
    fuzz = f[rf._F_FUZZ]
    mdx = rfx / rlen + fuzz * rux
    mdy = rfy / rlen + fuzz * ruy
    mdz = rfz / rlen + fuzz * ruz
    metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0

    ior = f[rf._F_IOR]
    ri = torch.where(front, 1.0 / ior, ior)
    dlen = torch.sqrt(dx * dx + dy * dy + dz * dz)
    udx, udy, udz = dx / dlen, dy / dlen, dz / dlen
    inner = -(udx * nx + udy * ny + udz * nz)
    cost = torch.where(inner < 1.0, inner, 1.0)
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    cannot = ri * sint > 1.0
    r0s = (1.0 - ri) / (1.0 + ri)
    r0 = r0s * r0s
    x1 = 1.0 - cost
    x2 = x1 * x1
    refl = r0 + (1.0 - r0) * (x1 * (x2 * x2))  # (1 - cos)^5 as the reference's integer_pow
    usef = cannot | (refl > u2)
    ppx = ri * (udx + cost * nx)
    ppy = ri * (udy + cost * ny)
    ppz = ri * (udz + cost * nz)
    k = torch.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz))
    kpos = k > 0.0
    kroot = torch.where(kpos, torch.sqrt(torch.where(kpos, k, 1.0)), 0.0)
    udn = udx * nx + udy * ny + udz * nz
    gdx = torch.where(usef, udx - 2.0 * udn * nx, ppx - kroot * nx)
    gdy = torch.where(usef, udy - 2.0 * udn * ny, ppy - kroot * ny)
    gdz = torch.where(usef, udz - 2.0 * udn * nz, ppz - kroot * nz)

    mtype = f[rf._F_MTYPE]
    is_metal = mtype == float(MAT_METAL)
    is_diel = mtype == float(MAT_DIELECTRIC)
    is_light = mtype == float(MAT_DIFFUSE_LIGHT)
    ndx = torch.where(is_diel, gdx, torch.where(is_metal, mdx, ldx))
    ndy = torch.where(is_diel, gdy, torch.where(is_metal, mdy, ldy))
    ndz = torch.where(is_diel, gdz, torch.where(is_metal, mdz, ldz))
    att_r = torch.where(is_diel, 1.0, tex_r)
    att_g = torch.where(is_diel, 1.0, tex_g)
    att_b = torch.where(is_diel, 1.0, tex_b)
    did_scatter = ((is_metal & metal_ok) | (~is_metal & ~is_light)) & ~is_light

    bg_r, bg_g, bg_b = bg
    miss = act & ~has_id
    rr = rr + torch.where(miss, tr * bg_r, 0.0)
    rg = rg + torch.where(miss, tg * bg_g, 0.0)
    rb = rb + torch.where(miss, tb * bg_b, 0.0)
    emit = act & has_id & is_light
    rr = rr + torch.where(emit, tr * tex_r, 0.0)
    rg = rg + torch.where(emit, tg * tex_g, 0.0)
    rb = rb + torch.where(emit, tb * tex_b, 0.0)
    live = act & has_id & did_scatter
    return (torch.where(live, px, ox), torch.where(live, py, oy), torch.where(live, pz, oz),
            torch.where(live, ndx, dx), torch.where(live, ndy, dy), torch.where(live, ndz, dz),
            rr, rg, rb,
            torch.where(live, tr * att_r, tr), torch.where(live, tg * att_g, tg),
            torch.where(live, tb * att_b, tb), live)


def _replay_chain(table, ids, ray_f, ray_i, maxlen, seed, n_sph, has_moving, background,
                  leaves=None):
    """The plain replay: every bounce for every ray, vectorised. With
    ``leaves`` (a list), each bounce's gathered table rows are detached
    leaves that require grad, appended to it (one per bounce run, None
    for the bounces no ray reached). Returns ``(rad (3, n), bounces)``."""
    n = ray_f.shape[1]
    D = ids.shape[0]
    dev = ray_f.device
    ox, oy, oz, dx, dy, dz, tm, act_f = ray_f.unbind(0)
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    one = z + 1.0
    act = act_f > 0.5
    st = (ox, oy, oz, dx, dy, dz, z, z, z, one, one, one, act)
    gate = maxlen.repeat_interleave(TILE)[:n]
    pix, smp = ray_i[0], ray_i[1]
    bg = tuple(float(x) for x in background)
    bounces = torch.zeros(n, dtype=torch.int32, device=dev)
    for b in range(D):
        act = st[12] & (gate > b)  # a gated tile's bounce is skipped: its rays stop here
        if not bool(act.any()):
            if leaves is not None:
                leaves.extend([None] * (D - b))
            break
        st = st[:12] + (act,)
        bounces = bounces + act.to(torch.int32)
        ids_b = ids[b]
        has_id = ids_b >= 0
        pid = torch.where(has_id, ids_b, 0).long()
        v = table[pid]
        if leaves is not None:
            v = v.detach().requires_grad_(True)
            leaves.append(v)
        st = _bounce(v, has_id, pid, st, tm, pix, smp, seed, b, n_sph, has_moving, bg)
    return torch.stack(st[6:9]), bounces


def replay_fwd_torch(table, ids, ray_f, ray_i, maxlen, *, seed: int, n_sph: int,
                     has_moving: bool, background):
    """Plain K3 with the kernel's inputs, outputs and arithmetic."""
    with torch.no_grad():
        return _replay_chain(table, ids, ray_f, ray_i, maxlen, seed, n_sph, has_moving,
                             background)


def replay_bwd_torch(table, ids, ray_f, ray_i, rad_bar, maxlen, *, seed: int, n_sph: int,
                     has_moving: bool, background):
    """Plain K2: the ``(D, NG, n)`` cotangents by autograd through the
    plain forward, each bounce's gathered rows a leaf (its ``.grad`` is
    the per-(bounce, ray) field cotangent)."""
    n, D = ray_f.shape[1], ids.shape[0]
    g = torch.zeros((D, NG, n), dtype=torch.float32, device=ray_f.device)
    leaves = []
    with torch.enable_grad():
        rad, _ = _replay_chain(table.detach(), ids, ray_f, ray_i, maxlen, seed, n_sph,
                               has_moving, background, leaves=leaves)
        run = [v for v in leaves if v is not None]
        if run:
            grads = torch.autograd.grad((rad * rad_bar).sum(), run, allow_unused=True)
            for b, gb in enumerate(grads):
                if gb is not None:
                    g[b, _GSLOTS] = gb[:, _TCOLS].T
    return g


# --------------------------------------------------------------------------
# the table-gradient reduction and the autograd function
# --------------------------------------------------------------------------

def reduce_table_grads(g, ids, L: int, prefixes=None):
    """Fold per-(bounce, ray) cotangents ``g (D, NG, n)`` into the packed
    table's cotangent ``tbar (L, N_FIELDS)``: row ``ids[b, i]`` gets
    ``g[b, :, i]`` (misses, id -1, add to row 0 with zero cotangents).
    ``prefixes``: per bounce, only the first ``prefixes[b]`` rays count.
    The sum is :func:`table_gather.fold <raytracing_tpu_torch.ops.table_gather.fold>`,
    one launch per window of at most ``FOLD_MAX_D`` bounces on the card
    (``table_gather.fold_windows``; ``index_add_`` per bounce, its plain
    version, on the CPU); the reference's one-hot matmul was
    measured slower on the card than either (PERF.md; ``chip_smoke.py``
    times all three). On CUDA it adds with atomics in a run-dependent
    order, so two runs agree to f32 reassociation, not bit for bit."""
    acc = fold(g, ids.to(torch.int32), L, prefixes)
    tbar = torch.zeros((L, rf.N_FIELDS), dtype=torch.float32, device=g.device)
    for tc, gs, n in _COPY_RUNS:
        tbar[:, tc:tc + n] = acc[:, gs:gs + n]
    return tbar


class _ReplayTrace(torch.autograd.Function):
    """K3 forward (or a given radiance), K2 backward, reduced to the table."""

    @staticmethod
    def forward(ctx, table, ids, ray_f, ray_i, maxlen, kw, rad_pre, seg_pre):
        if rad_pre is None:
            rad, bc = replay_fwd(table, ids, ray_f, ray_i, maxlen, **kw)
            radiance, segments = rad.T.contiguous(), bc.to(torch.int64).sum()
        else:
            radiance, segments = rad_pre.clone(), seg_pre
        ctx.save_for_backward(table, ids, ray_f, ray_i, maxlen)
        ctx.kw = kw
        ctx.mark_non_differentiable(segments)
        return radiance, segments

    @staticmethod
    def backward(ctx, rad_bar, _seg_bar):
        table, ids, ray_f, ray_i, maxlen = ctx.saved_tensors
        g = replay_bwd(table, ids, ray_f, ray_i, rad_bar.T.contiguous(), maxlen, **ctx.kw)
        return reduce_table_grads(g, ids, table.shape[0]), None, None, None, None, None, None, None


def replay_trace_kernel(scene, ids, o, d, time, pixel_ids, sample_ids, background,
                        max_depth: int, seed: int, active0=None, lengths=None,
                        radiance_in=None):
    """Replay the recorded ``ids (max_depth, B) i32`` through K3, with K2
    as its backward: returns ``(radiance (B, 3), segments)``, the radiance
    differentiable in the scene's tensors through
    :func:`build_replay_table <raytracing_tpu_torch.diff.replay_fast.build_replay_table>`.
    Rays and camera get no gradient.

    ``lengths``: per-ray recorded bounce counts (``want_counts``); each
    TILE of rays then skips the bounces past its longest ray, with the
    same result. ``radiance_in`` (requires ``lengths``): the decision
    pass's own radiance, returned as the forward value (segments from the
    lengths) without running K3; the backward still runs K2."""
    B = o.shape[0]
    if B % TILE:
        raise ValueError(f"replay batch must be a multiple of {TILE}, got {B}")
    if radiance_in is not None and lengths is None:
        raise ValueError("radiance_in requires lengths")
    table = rf.build_replay_table(scene)
    ray_f = pack_replay_rays(o.detach(), d.detach(), time.detach(), active0)
    ray_i = torch.stack([pixel_ids, sample_ids]).to(torch.int32)
    if lengths is None:
        maxlen = torch.full((B // TILE,), max_depth, dtype=torch.int32, device=o.device)
    else:
        maxlen = tile_maxlen(lengths, max_depth)
    kw = dict(seed=int(seed), n_sph=scene.n_spheres, has_moving=scene.flags.has_moving,
              background=tuple(float(x) for x in background))
    seg_pre = None if lengths is None else lengths.to(torch.int64).sum()
    rad_pre = None if radiance_in is None else radiance_in.detach()
    return _ReplayTrace.apply(table, ids.to(torch.int32).contiguous(), ray_f, ray_i, maxlen, kw,
                              rad_pre, seg_pre)


def replay_grads_sorted(scene, table, background, max_depth: int, seed: int, rad_bar, lengths,
                        *, ids=None, rays=None, ray_regen=None, prefixes=None, compacted=None):
    """The scene-gradient pass over recorded decisions with the rays
    sorted by recorded path length (the fwd+bwd bench's path): K2 on the
    sorted rays, then the per-bounce table-gradient reduction.

    The caller computes the loss and the per-ray radiance cotangent
    ``rad_bar (B, 3)`` from the decision pass's own radiance, so no
    forward replay runs. One sort on the unique key ``(D - len)·B + i``
    orders the rays by descending length: K2's tile gating then skips
    nearly everything past each ray's death, and bounce ``b``'s gradient
    rows all lie in the prefix of rays with length > b, which a static
    plan (``prefixes``, from :func:`plan_prefixes`) cuts the reduction
    to. The rays come one of two ways, with the same result:

    * ``rays=(o, d, time, pixel_ids, sample_ids)``: every per-ray column
      is gathered into the sorted order;
    * ``ray_regen(orig, alive) -> (ray_f, ray_i)`` recomputes the rays
      from their original index (camera rays are pure functions of it) as
      K2's packed inputs, ``ray_f (N_RAY_F, B)`` alive where ``alive``
      is (e.g. :func:`replay_rays`) and ``ray_i (2, B) i32``, so only
      the key, ``rad_bar`` and the ids move.

    The ids come as ``ids (D, B)`` in camera order or as ``compacted``
    (requires ``ray_regen``): the bundle of
    ``trace_megakernel(want_ids="compacted")``, ``dict(ids0, later, perm,
    counts_c, phase_depths)``; the later phases' ids move straight from
    the compacted order to the length order by a second sort over the
    same key set.

    Returns ``(tbar (L, N_FIELDS), ok)``: the cotangent of ``table`` (feed
    it to autograd through ``build_replay_table``) and a 0-d bool tensor,
    False when a bounce's live rays exceeded its planned prefix (a
    contribution was dropped: replan).

    Stages (``utils.profiling``): ``sort`` (the key, the sorts, the
    gathers and the prefix checks), ``camera`` (``ray_regen``: the packed
    rays), ``sort`` (K2's inputs, and without ``ray_regen`` the packed
    rays), ``k2`` and ``fold``."""
    B = lengths.shape[0]
    D = max_depth
    if B % TILE:
        raise ValueError(f"replay batch must be a multiple of {TILE}, got {B}")
    if (rays is None) == (ray_regen is None):
        raise ValueError("pass the rays (rays=) or their regeneration (ray_regen=), not both")
    if (ids is None) == (compacted is None):
        raise ValueError("pass the ids (ids=) or the compacted bundle (compacted=), not both")
    if compacted is not None:
        if ray_regen is None:
            raise ValueError("compacted ids require ray_regen")
        pdep = tuple(compacted["phase_depths"])
        if sum(pdep) != D or compacted["ids0"].shape[0] != pdep[0]:
            raise ValueError(f"compacted bundle phases {pdep} do not match depth {D}")
    if prefixes is not None:
        if len(prefixes) != D:
            raise ValueError(f"prefixes: one per bounce ({D}), got {len(prefixes)}")
        prefixes = [min(B, -(-int(p) // TILE) * TILE) for p in prefixes]
    dev = lengths.device
    with stage("sort", dev):
        lengths = lengths.detach().to(torch.int64)
        rad_bar = rad_bar.detach()
        key = (D - lengths) * B + torch.arange(B, device=dev)
        if compacted is not None:
            key_c = ((D - compacted["counts_c"].to(torch.int64)) * B
                     + compacted["perm"].to(torch.int64))
            order_c = torch.argsort(key_c)
            order = torch.argsort(key)
            key_s = key[order]
            ids_s = torch.cat([compacted["ids0"][:, order], compacted["later"][:, order_c]])
        else:
            order = torch.argsort(key)
            key_s = key[order]
            ids_s = ids[:, order]
        rad_bar_s = rad_bar[order]
        len_s = D - torch.div(key_s, B, rounding_mode="floor")
        alive_s = len_s > 0
        ok = torch.ones((), dtype=torch.bool, device=dev)
        for b, P in enumerate(prefixes or ()):
            # sorted by descending length: the first excluded ray must be dead at b
            if P < B:
                ok = ok & (len_s[P] <= b)
        if ray_regen is None:
            o_s, d_s, t_s, pix_s, smp_s = (x[order] for x in rays)
        else:
            orig = key_s % B
    if ray_regen is not None:
        with stage("camera", dev):
            ray_f, ray_i = ray_regen(orig, alive_s)
    with stage("sort", dev):
        if ray_regen is None:
            ray_f = pack_replay_rays(o_s.detach(), d_s.detach(), t_s.detach(), alive_s)
            ray_i = torch.stack([pix_s, smp_s]).to(torch.int32)
        args = (table.detach().contiguous(), ids_s.to(torch.int32).contiguous(), ray_f, ray_i,
                rad_bar_s.T.contiguous(), tile_maxlen(len_s, D))
    with stage("k2", dev):
        g = replay_bwd(*args, seed=int(seed), n_sph=scene.n_spheres,
                       has_moving=scene.flags.has_moving,
                       background=tuple(float(x) for x in background))
    with stage("fold", dev):
        return reduce_table_grads(g, ids_s, table.shape[0], prefixes), ok
