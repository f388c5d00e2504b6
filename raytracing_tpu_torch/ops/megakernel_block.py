"""K1, the block megakernel: one phase of up to ``max_depth`` bounces for
every ray of a launch. It replaces the Pallas kernel
``raytracing_tpu/ops/megakernel_block.py`` ``make_megakernel_block``.

Per bounce and ray: the closest hit over every sphere row (moving center
at ray time, roots searched in a·t space, strict < so the lowest index
wins ties) and then every quad row; the winner's attributes from the
unified table; solid, checker, 7-octave marble or nearest-texel image
albedo; lambertian, metal, dielectric or light; the next direction from
PCG4D keyed on (pix, smp, (b + b_off)·4 + 2, seed). With ``want_ids`` it
also records, per bounce, the global scene id of the winner (through
``MegaScene.kid_map``): the decision pass that the gradient replay
(``diff/replay_kernel.py``) differentiates. With ``depth_cap`` (the
regenerating pool, ``render/pool.py``) every ray carries its own depth
``dep``, which offsets its RNG counter and caps its path.

Participating media (``MegaScene.media``, The Next Week's
``constant_medium``; K1's MEDIUM instantiations) are tested after the
surfaces, against every ray: medium k draws its free path -ln(u)/density
from lane k of the PCG4D draw keyed on (pix, smp, (b + b_off)·4 + 3,
seed), clamps its entry root to T_MIN, and wins the bounce when the
entry plus the free path over |d| lies below both its exit and the
closest hit so far; the ray then scatters there into a uniform direction
(the scatter draw's first two lanes) with the medium's albedo as
attenuation. Such a bounce is a segment, and adds one to
:data:`medium_scatters`. Media take neither ``want_ids`` (the replay
does not trace them) nor ``depth_cap``.

Two implementations compute it:

* ``csrc/megakernel_block.cu``, a CUDA C++ kernel for sm_90a, one thread
  per ray (see the note at the top of that file). Its closest hit comes
  from one of two searches with one result, bit for bit: the sweep over
  every row, or a walk of the chunked BVH (``MegaScene.cull_nodes``) that
  tests a hit leaf's rows with the sweep's arithmetic;
* :func:`trace_block_torch`, the plain PyTorch version (the sweep),
  vectorized over rays and over primitives in chunks.

:func:`trace_block` is the wrapper: tensors on the CPU go to the plain
version, tensors on a CUDA device launch the kernel, anything else
raises. Each kernel launch adds one to :data:`launches`. Its ``cull``
keyword picks the kernel's search: None walks on scenes of at least
:data:`CULL_MIN_PRIMS` primitives and sweeps smaller ones, True walks,
False sweeps.

Ray state is two tensors: ``ray_f (N_F, n) f32`` with rows
``OX OY OZ DX DY DZ TM TR TG TB RR RG RB ACT`` (origin, direction, time,
throughput, radiance, alive flag) and ``ray_i (2, n) i32`` with rows
``PIX SMP`` (the RNG identity). Outputs are ``rad (3, n) f32``,
``bounces (n,) i32``, with ``want_state`` the new ``ray_f``, and with
``want_ids`` ``ids (max_depth, n) i32``: -1 on a miss and on every bounce
after the ray died.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _kernels
from ..core import rng as rng_mod
from ..core.vecmath import NEAR_ZERO_EPS
from ..scene import flatten as fl
from ..scene import perlin
from ..scene.types import PerlinTables
from .intersect import PARALLEL_EPS, T_MIN, atan2_rn

OX, OY, OZ, DX, DY, DZ, TM, TR, TG, TB, RR, RG, RB, ACT = range(14)
N_F = 14
PIX, SMP = 0, 1

BIG = 3.0e38  # K1's miss sentinel: a miss keeps exactly this t
MT_METAL = 1.0
MT_DIELECTRIC = 2.0
MT_LIGHT = 3.0

# the sweep stages the sweep tables (and the noise tables) in one block's
# shared memory
MAX_SHARED_BYTES = 232448
# K1 walks the BVH on scenes of at least this many primitives (spheres and
# quads, 8 chunks) and sweeps every row below it: on the card the sweep
# was as fast or faster up to 40 primitives (and on cornell_box's 18
# quads), the walk faster from 67 (PERF.md, chip_smoke.py phase 22). It
# changes speed, never a result.
CULL_MIN_PRIMS = 64
# primitives per vectorized step of the plain version's sweep
PLAIN_CHUNK = 128

launches = _kernels.LaunchCount()  # K1 kernel launches (plain-version calls excluded)
# K1 launches whose lanes start from the camera (``camera=``), among ``launches``
camera_launches = _kernels.LaunchCount()
# bounces won by a participating medium, kernel and plain version alike (a
# launch's threads add theirs once a warp at its end)
medium_scatters = _kernels.DeviceCount()


def pack_rays(o, d, time, pixel_ids, sample_ids, active0=None):
    """Camera rays → K1's ray state: ``ray_f (N_F, B)`` with unit
    throughput, zero radiance and the alive flag, and ``ray_i (2, B)``."""
    ray_f = torch.empty((N_F, o.shape[0]), dtype=torch.float32, device=o.device)
    ray_f[OX:OZ + 1] = o.T
    ray_f[DX:DZ + 1] = d.T
    ray_f[TM] = time
    ray_f[TR:TB + 1] = 1.0
    ray_f[RR:RB + 1] = 0.0
    ray_f[ACT] = 1.0 if active0 is None else active0.to(torch.float32)
    return ray_f, torch.stack([pixel_ids, sample_ids]).to(torch.int32)


def _sweep_rows(mega):
    """Rows the sweeps visit: none for a kind the scene does not have."""
    n_sph_rows = mega.sph_sweep.shape[0] if mega.n_sph > 0 else 0
    n_quad_rows = mega.quad_sweep.shape[0] if mega.n_quad > 0 else 0
    return n_sph_rows, n_quad_rows


def _media_options(mega, want_ids, depth_cap) -> None:
    """Media are traced without ``want_ids`` (no replay traces them) and
    without a depth cap (the pool): refuse either on a scene with media."""
    if mega.n_media and (want_ids or depth_cap is not None):
        raise ValueError(f"this scene has {mega.n_media} participating media, which K1 traces "
                         f"without want_ids (the replay does not trace them) and without a "
                         f"depth cap (the pool)")


def walks(mega, cull=None) -> bool:
    """Whether K1 searches ``mega`` by the BVH walk (else the sweep):
    ``cull`` when it is a bool, else by the scene's primitive count."""
    if cull is None:
        return mega.n_sph + mega.n_quad >= CULL_MIN_PRIMS
    if not isinstance(cull, bool):
        raise ValueError(f"cull must be None, True or False, got {cull!r}")
    return cull


def trace_block(mega, ray_f, ray_i: torch.Tensor, seed: int,
                b_off: int, *, max_depth: int, background,
                want_state: bool = True, want_ids: bool = False,
                depth_cap=None, dep=None, cull=None, camera=None, alive=None):
    """Trace one phase of ``max_depth`` bounces. Returns
    ``(rad (3, n), bounces (n,) i32, state (N_F, n) or None)``, and
    ``ids (max_depth, n) i32`` after them with ``want_ids``. ``cull``
    picks the kernel's search (:func:`walks`); the plain version sweeps.

    ``camera`` (a ``render.camera.CameraStart``) starts every lane from
    its camera ray in place of ``ray_f``, which must then be None: the
    kernel computes lane i's ray from ``ray_i[:, i]`` and the seed, bit
    for bit the ray ``generate_rays`` gives, with unit throughput and zero
    radiance, alive where ``alive (n,) bool`` is (None: every lane), as
    :func:`pack_rays` packs them. Each such launch also adds one to
    :data:`camera_launches`.

    ``depth_cap`` (the regenerating pool, ``render/pool.py``) takes
    ``dep (n,) i32``, each ray's segments traced before this launch: its
    bounce ``b`` draws from RNG counter ``(b + b_off + dep)·4 + 2``, and
    it dies, its state kept, once ``dep + b + 1`` reaches ``depth_cap``.
    Pass ``dep`` exactly when ``depth_cap`` is set."""
    if ray_i.dim() != 2 or ray_i.shape[0] != 2 or ray_i.dtype != torch.int32:
        raise ValueError(f"ray_i must be (2, n) int32, got {tuple(ray_i.shape)} {ray_i.dtype}")
    n = ray_i.shape[1]
    if (dep is None) != (depth_cap is None):
        raise ValueError("pass dep exactly when depth_cap is set")
    if camera is None:
        if alive is not None:
            raise ValueError("alive belongs to a camera start; ray_f holds the alive flags")
        if ray_f is None or ray_f.shape != (N_F, n) or ray_f.dtype != torch.float32:
            raise ValueError(f"ray_f must be ({N_F}, n) float32, got "
                             f"{None if ray_f is None else (tuple(ray_f.shape), ray_f.dtype)}")
    elif ray_f is not None:
        raise ValueError("a camera start computes the lanes' rays: pass ray_f=None")
    if dep is not None and (dep.shape != (n,) or dep.dtype != torch.int32):
        raise ValueError(f"dep must be ({n},) int32, got {tuple(dep.shape)} {dep.dtype}")
    if alive is not None and (alive.shape != (n,) or alive.dtype != torch.bool):
        raise ValueError(f"alive must be ({n},) bool, got {tuple(alive.shape)} {alive.dtype}")
    _media_options(mega, want_ids, depth_cap)
    walk = walks(mega, cull)
    dev = ray_i.device
    if camera is not None:
        camera.check(dev)
    tables = (mega.sph_sweep, mega.quad_sweep, mega.table, mega.kid_map, mega.perm, mega.grad,
              mega.atlas, mega.cull_nodes, mega.sph_gid, mega.quad_gid, mega.media)
    rays = tuple(t for t in (ray_f, ray_i, dep, alive) if t is not None)
    if any(t.device != dev for t in (*rays, *tables)):
        raise ValueError("scene tables and ray state must be on one device")
    if dev.type == "cpu":
        return trace_block_torch(mega, ray_f, ray_i, seed, b_off,
                                 max_depth=max_depth, background=background,
                                 want_state=want_state, want_ids=want_ids,
                                 depth_cap=depth_cap, dep=dep, camera=camera, alive=alive)
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors (kernel) or CPU tensors (plain version), not {dev}")
    if not all(t.is_contiguous() for t in (*rays, *tables)):
        raise ValueError("K1 needs contiguous tensors")
    # the kernel's sweep skips the tables' pad rows, which never win; it
    # stages the real rows and the 6 KB of noise tables per block (the
    # walk at most 48 KB of nodes)
    n_sph_rows, n_quad_rows = mega.n_sph, mega.n_quad
    smem = ((n_sph_rows * 8 + n_quad_rows * 16)
            + (mega.perm.numel() + mega.grad.numel() if mega.has_noise else 0)) * 4
    if not walk and smem > MAX_SHARED_BYTES:
        raise ValueError(f"sweep and noise tables need {smem} B of shared memory; K1's sweep "
                         f"stages at most {MAX_SHARED_BYTES} B: walk this scene (cull=True)")
    if n >= 2 ** 31 // N_F:
        raise ValueError(f"K1 launch of {n} rays exceeds its 32-bit indexing")

    lib = _kernels.library().lib
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    bounces = torch.empty((n,), dtype=torch.int32, device=dev)
    state = torch.empty((N_F, n), dtype=torch.float32, device=dev) if want_state else None
    ids = torch.empty((max_depth, n), dtype=torch.int32, device=dev) if want_ids else None
    out = (rad, bounces, state, ids) if want_ids else (rad, bounces, state)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rt_trace_block(
            mega.sph_sweep.data_ptr(), n_sph_rows,
            mega.quad_sweep.data_ptr(), n_quad_rows,
            mega.table.data_ptr(), mega.n_prims,
            ray_f.data_ptr() if ray_f is not None else None, ray_i.data_ptr(), n,
            rad.data_ptr(), bounces.data_ptr(),
            state.data_ptr() if want_state else None, mega.kid_map.data_ptr(),
            ids.data_ptr() if want_ids else None, ctypes.c_uint32(seed), ctypes.c_uint32(b_off), max_depth,
            mega.n_sph_pad, float(background[0]), float(background[1]),
            float(background[2]), int(mega.moving), int(mega.has_noise), int(mega.has_image),
            mega.perm.data_ptr(), mega.grad.data_ptr(), mega.atlas.data_ptr(),
            dep.data_ptr() if dep is not None else None,
            depth_cap if depth_cap is not None else 0,
            mega.cull_nodes.data_ptr(), mega.cull_nodes.shape[0], mega.sph_gid.data_ptr(),
            mega.n_sph_chunks, mega.quad_gid.data_ptr(), *mega.cull_ball, int(walk),
            camera.camera.data_ptr() if camera is not None else None,
            alive.data_ptr() if alive is not None else None,
            camera.width if camera is not None else 0,
            camera.flags if camera is not None else 0, stream, mega.n_media,
            mega.media.data_ptr(),
            medium_scatters.tensor(dev).data_ptr() if mega.n_media else None)
    launches.add(dev)
    if camera is not None:
        camera_launches.add(dev)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: {lib.rt_error_string(err).decode()}")
    return out


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _closest_hit(mega, ox, oy, oz, dx, dy, dz, tm):
    """(t, ib): nearest hit distance (BIG on a miss) and winner column
    (-1 on a miss), with the kernel's arithmetic and tie order."""
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    ta = (T_MIN * a)[:, None]
    n = ox.shape[0]
    ib = torch.full((n,), -1, dtype=torch.int64, device=ox.device)
    n_sph_rows, n_quad_rows = _sweep_rows(mega)
    inf = math.inf
    c = [x[:, None] for x in (ox, oy, oz, dx, dy, dz, tm)]
    rox, roy, roz, rdx, rdy, rdz, rtm = c
    sb = torch.full((n,), BIG, dtype=torch.float32, device=ox.device)
    for j0 in range(0, n_sph_rows, PLAIN_CHUNK):
        s_tab = mega.sph_sweep[j0:j0 + PLAIN_CHUNK].T
        if mega.moving:
            ocx = (rox - s_tab[0]) - rtm * s_tab[3]
            ocy = (roy - s_tab[1]) - rtm * s_tab[4]
            ocz = (roz - s_tab[2]) - rtm * s_tab[5]
        else:
            ocx, ocy, ocz = rox - s_tab[0], roy - s_tab[1], roz - s_tab[2]
        half_b = ocx * rdx + ocy * rdy + ocz * rdz
        cq = ocx * ocx + ocy * ocy + (ocz * ocz - s_tab[6])
        disc = half_b * half_b - a[:, None] * cq
        sq = torch.sqrt(disc)  # NaN on a miss: every comparison below fails
        nhb = -half_b
        s0 = nhb - sq
        s1 = nhb + sq
        s = torch.where(s0 > ta, s0, s1)
        s = torch.where(s > ta, s, inf)
        smin, arg = torch.min(s, dim=1)  # first index among equal minima
        imp = smin < sb
        sb = torch.where(imp, smin, sb)
        ib = torch.where(imp, arg + j0, ib)
    t = torch.where(ib >= 0, sb * inv_a, BIG)
    for j0 in range(0, n_quad_rows, PLAIN_CHUNK):
        q = mega.quad_sweep[j0:j0 + PLAIN_CHUNK].T
        nx, ny, nz = q[0], q[1], q[2]
        denom = nx * rdx + ny * rdy + nz * rdz
        safe = torch.where(torch.abs(denom) < PARALLEL_EPS, 1.0, denom)
        tq = (q[3] - (nx * rox + ny * roy + nz * roz)) / safe
        px = rox + tq * rdx - q[4]
        py = roy + tq * rdy - q[5]
        pz = roz + tq * rdz - q[6]
        wx, wy, wz, ux, uy, uz, vx, vy, vz = q[7:16]
        alpha = (wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz)
                 + wz * (px * vy - py * vx))
        beta = (wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz)
                + wz * (ux * py - uy * px))
        imp = ((torch.abs(denom) >= PARALLEL_EPS) & (tq > T_MIN)
               & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0))
        tmin_q, arg = torch.min(torch.where(imp, tq, inf), dim=1)
        better = tmin_q < t
        t = torch.where(better, tmin_q, t)
        ib = torch.where(better, arg + j0 + mega.n_sph_pad, ib)
    return t, ib


def image_texel(mega, ib, px, py, pz, own_x, own_y, own_z):
    """The nearest texel of an image hit: ``(flat, x, y)``, the atlas row
    and the continuous texel coordinates it truncates (``x = u·w``, ``y =
    (1 - v)·h`` after clamping). A sphere's (u, v) comes from its outward
    normal: θ = atan2(√(x²+z²), -y), φ = atan2(-z, x) + π (x taken as 1 on
    the poles); a quad's is (α, β) from its corner, edges and w."""
    col = mega.table[:, ib]
    rxz = torch.sqrt(torch.clamp(own_x * own_x + own_z * own_z, min=0.0))
    theta = atan2_rn(rxz, -own_y)
    x_safe = torch.where(rxz > 0.0, own_x, 1.0)
    phi = atan2_rn(-own_z, x_safe) + math.pi
    u = phi * (1.0 / (2.0 * math.pi))
    v = theta * (1.0 / math.pi)
    if mega.n_quad > 0:
        is_quad = ib >= mega.n_sph_pad
        pqx = px - col[fl.U_QX]
        pqy = py - col[fl.U_QY]
        pqz = pz - col[fl.U_QZ]
        ux, uy, uz = col[fl.U_UX], col[fl.U_UY], col[fl.U_UZ]
        vx, vy, vz = col[fl.U_VX], col[fl.U_VY], col[fl.U_VZ]
        wx, wy, wz = col[fl.U_G4], col[fl.U_G5], col[fl.U_G6]
        alpha = (wx * (pqy * vz - pqz * vy) + wy * (pqz * vx - pqx * vz)
                 + wz * (pqx * vy - pqy * vx))
        beta = (wx * (uy * pqz - uz * pqy) + wy * (uz * pqx - ux * pqz)
                + wz * (ux * pqy - uy * pqx))
        u = torch.where(is_quad, alpha, u)
        v = torch.where(is_quad, beta, v)
    w_img, h_img = col[fl.U_A2G], col[fl.U_A2B]
    w_i, h_i = w_img.to(torch.int32), h_img.to(torch.int32)
    x = torch.clamp(u, 0.0, 1.0) * w_img
    y = (1.0 - torch.clamp(v, 0.0, 1.0)) * h_img
    ti = torch.minimum(torch.clamp(x.to(torch.int32), min=0), torch.clamp(w_i - 1, min=0))
    tj = torch.minimum(torch.clamp(y.to(torch.int32), min=0), torch.clamp(h_i - 1, min=0))
    flat = col[fl.U_A2R].to(torch.int32) + tj * w_i + ti
    return flat.long(), x, y


def _media_hit(mega, st, t, ib, b: int, b_off: int, seed: int, pix, smp):
    """``(t, ib)`` after the media (``ib = -2 - k`` where medium k wins),
    with the kernel's arithmetic: each medium's boundary roots in a·t
    space, the entry clamped to T_MIN and the exit to the closest hit so
    far, and the free path ``(-1/density)·ln(u)``, u lane k of the
    STREAM_MEDIUM draw (the log in float64, rounded to float32)."""
    ox, oy, oz, dx, dy, dz = st[OX:DZ + 1]
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    length = torch.sqrt(a)
    ctr = torch.full_like(pix, (b + b_off) * rng_mod.N_STREAMS + rng_mod.STREAM_MEDIUM,
                          dtype=torch.int64)
    words = rng_mod.pcg4d(pix, smp, ctr, torch.full_like(pix, seed, dtype=torch.int64))
    for k in range(mega.n_media):
        m = mega.media[k]
        ocx, ocy, ocz = ox - m[fl.M_CX], oy - m[fl.M_CY], oz - m[fl.M_CZ]
        half_b = ocx * dx + ocy * dy + ocz * dz
        cq = ocx * ocx + ocy * ocy + (ocz * ocz - m[fl.M_R2])
        disc = half_b * half_b - a * cq
        sq = torch.sqrt(disc)  # NaN on a miss: every comparison below fails
        nhb = -half_b
        t1 = torch.clamp((nhb - sq) * inv_a, min=T_MIN)
        t2 = torch.minimum((nhb + sq) * inv_a, t)
        u = rng_mod.to_unit_float(words[k])
        free = m[fl.M_NID] * torch.log(u.double()).float()
        tm = t1 + free / length
        win = (disc >= 0.0) & (t1 < t2) & (tm < t2)
        t = torch.where(win, tm, t)
        ib = torch.where(win, -2 - k, ib)
    return t, ib


def shade(mega, st, t, ib, b: int, b_off: int, seed: int, pix, smp, background,
          dep=None, depth_cap=None):
    """One bounce after the closest hit ``(t, ib)`` (``t == BIG`` on a miss),
    shared by K1's and K5's plain versions: background on a miss, the
    winner's fields from the unified table, solid, checker, marble or image
    albedo, emission, and the scatter of a lambertian, metal or dielectric
    surface, or of a medium (``ib <= -2``, :func:`_media_hit`): a uniform
    direction, its albedo as attenuation. ``st`` is the ray state as a
    list in ``ray_f``'s row order, with a bool ``active`` last; returns
    the state after the bounce. With
    ``depth_cap``, ``dep (n,) i32`` holds each ray's segments before this
    phase: its RNG counter gains ``dep·4`` and the ray dies after segment
    ``depth_cap``."""
    ox, oy, oz, dx, dy, dz, tm, thr_r, thr_g, thr_b, rad_r, rad_g, rad_b, active = st
    bg_r, bg_g, bg_b = (float(x) for x in background)
    res = mega.resolve
    ns_pad = mega.n_sph_pad
    hit = t < BIG
    miss = active & ~hit
    rad_r = rad_r + torch.where(miss, thr_r * bg_r, 0.0)
    rad_g = rad_g + torch.where(miss, thr_g * bg_g, 0.0)
    rad_b = rad_b + torch.where(miss, thr_b * bg_b, 0.0)

    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz

    at = res[:, ib.clamp(min=0)]  # misses read column 0, masked below
    is_quad = ib >= ns_pad
    cxt = at[fl.U_G0] + tm * at[fl.U_G3]
    cyt = at[fl.U_G1] + tm * at[fl.U_G4]
    czt = at[fl.U_G2] + tm * at[fl.U_G5]
    r_att = at[fl.U_G6]
    inv_r = 1.0 / torch.where(r_att != 0.0, r_att, 1.0)
    own_x = torch.where(is_quad, at[fl.U_G0], (px - cxt) * inv_r)
    own_y = torch.where(is_quad, at[fl.U_G1], (py - cyt) * inv_r)
    own_z = torch.where(is_quad, at[fl.U_G2], (pz - czt) * inv_r)
    front = (dx * own_x + dy * own_y + dz * own_z) < 0.0
    sgn = torch.where(front, 1.0, -1.0)
    nx = own_x * sgn
    ny = own_y * sgn
    nz = own_z * sgn

    mt = at[fl.U_MTYPE]
    prm = at[fl.U_PARAM]
    ts = at[fl.U_TSCALE]
    cells = (torch.floor(ts * px).to(torch.int32)
             + torch.floor(ts * py).to(torch.int32)
             + torch.floor(ts * pz).to(torch.int32))
    use2 = (at[fl.U_TKIND] == fl.TK_CHECKER) & ((cells & 1) != 0)
    ar = torch.where(use2, at[fl.U_A2R], at[fl.U_AR])
    ag = torch.where(use2, at[fl.U_A2G], at[fl.U_AG])
    ab = torch.where(use2, at[fl.U_A2B], at[fl.U_AB])
    # a medium's bounce reads its albedo from the media table
    is_med = ib <= -2
    if mega.n_media:
        med = mega.media[(-2 - ib).clamp(min=0, max=mega.n_media - 1)].T
        ar = torch.where(is_med, med[fl.M_AR], ar)
        ag = torch.where(is_med, med[fl.M_AG], ag)
        ab = torch.where(is_med, med[fl.M_AB], ab)
    # marble and image albedo, evaluated only on the rays that hit them
    # (a miss's hit point may be infinite)
    shaded = active & hit & ~is_med
    if mega.has_noise:
        # scene/perlin.py's marble, in the kernels' operation order
        sel = torch.nonzero(shaded & (at[fl.U_TKIND] == fl.TK_NOISE)).flatten()
        m = perlin.marble(PerlinTables(mega.grad, *mega.perm),
                          torch.stack([px[sel], py[sel], pz[sel]], dim=-1), ts[sel])
        ar, ag, ab = (x.index_put((sel,), m) for x in (ar, ag, ab))
    if mega.has_image:
        sel = torch.nonzero(shaded & (at[fl.U_TKIND] == fl.TK_IMAGE)).flatten()
        flat = image_texel(mega, ib[sel], px[sel], py[sel], pz[sel], own_x[sel], own_y[sel],
                           own_z[sel])[0]
        tex = mega.atlas[flat]
        ar, ag, ab = (x.index_put((sel,), tex[:, c]) for c, x in enumerate((ar, ag, ab)))

    ctr = torch.full_like(pix, (b + b_off) * rng_mod.N_STREAMS + rng_mod.STREAM_SCATTER,
                          dtype=torch.int64)
    if dep is not None:  # each ray's stream continues at its own bounce index
        ctr = ctr + dep.to(torch.int64) * rng_mod.N_STREAMS
    v0, v1, v2, _ = rng_mod.pcg4d(pix, smp, ctr, torch.full_like(pix, seed, dtype=torch.int64))
    u0 = rng_mod.to_unit_float(v0)
    u1 = rng_mod.to_unit_float(v1)
    u2 = rng_mod.to_unit_float(v2)

    zdir = 1.0 - 2.0 * u0
    rho = torch.sqrt(torch.clamp(1.0 - zdir * zdir, min=0.0))
    phi_s = (2.0 * math.pi) * u1
    rux = rho * torch.cos(phi_s)
    ruy = rho * torch.sin(phi_s)
    ruz = zdir

    # lambertian
    ldx = nx + rux
    ldy = ny + ruy
    ldz = nz + ruz
    degen = ((torch.abs(ldx) < NEAR_ZERO_EPS) & (torch.abs(ldy) < NEAR_ZERO_EPS)
             & (torch.abs(ldz) < NEAR_ZERO_EPS))
    ldx = torch.where(degen, nx, ldx)
    ldy = torch.where(degen, ny, ldy)
    ldz = torch.where(degen, nz, ldz)

    # metal
    d_dot_on = dx * nx + dy * ny + dz * nz
    rdx = dx - 2.0 * d_dot_on * nx
    rdy = dy - 2.0 * d_dot_on * ny
    rdz = dz - 2.0 * d_dot_on * nz
    rlen = 1.0 / torch.sqrt(rdx * rdx + rdy * rdy + rdz * rdz + 1e-30)
    mdx = rdx * rlen + prm * rux
    mdy = rdy * rlen + prm * ruy
    mdz = rdz * rlen + prm * ruz
    metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0

    # dielectric
    dinv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-30)
    udx = dx * dinv
    udy = dy * dinv
    udz = dz * dinv
    ri = torch.where(front, 1.0 / prm, prm)
    cos_t = torch.clamp(-(udx * nx + udy * ny + udz * nz), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ri * sin_t > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    x1 = 1.0 - cos_t
    x2 = x1 * x1
    reflectance = r0 + (1.0 - r0) * (x1 * (x2 * x2))
    use_reflect = cannot | (reflectance > u2)
    rpx = ri * (udx + cos_t * nx)
    rpy = ri * (udy + cos_t * ny)
    rpz = ri * (udz + cos_t * nz)
    par = -torch.sqrt(torch.abs(1.0 - (rpx * rpx + rpy * rpy + rpz * rpz)))
    u_dot_n = udx * nx + udy * ny + udz * nz
    gdx = torch.where(use_reflect, udx - 2.0 * u_dot_n * nx, rpx + par * nx)
    gdy = torch.where(use_reflect, udy - 2.0 * u_dot_n * ny, rpy + par * ny)
    gdz = torch.where(use_reflect, udz - 2.0 * u_dot_n * nz, rpz + par * nz)

    is_metal = (mt == MT_METAL) & ~is_med
    is_diel = (mt == MT_DIELECTRIC) & ~is_med
    is_light = (mt == MT_LIGHT) & ~is_med
    ndx = torch.where(is_diel, gdx, torch.where(is_metal, mdx, torch.where(is_med, rux, ldx)))
    ndy = torch.where(is_diel, gdy, torch.where(is_metal, mdy, torch.where(is_med, ruy, ldy)))
    ndz = torch.where(is_diel, gdz, torch.where(is_metal, mdz, torch.where(is_med, ruz, ldz)))
    att_r = torch.where(is_diel, 1.0, ar)
    att_g = torch.where(is_diel, 1.0, ag)
    att_b = torch.where(is_diel, 1.0, ab)

    hit_mask = active & hit
    emit = hit_mask & is_light
    rad_r = rad_r + torch.where(emit, thr_r * ar, 0.0)
    rad_g = rad_g + torch.where(emit, thr_g * ag, 0.0)
    rad_b = rad_b + torch.where(emit, thr_b * ab, 0.0)

    live = hit_mask & ((is_metal & metal_ok) | (~is_metal & ~is_light))
    if depth_cap is not None:  # the ray's last segment: it dies with its state kept
        live = live & (dep + (b + 1) < depth_cap)
    thr_r = torch.where(live, thr_r * att_r, thr_r)
    thr_g = torch.where(live, thr_g * att_g, thr_g)
    thr_b = torch.where(live, thr_b * att_b, thr_b)
    ox = torch.where(live, px, ox)
    oy = torch.where(live, py, oy)
    oz = torch.where(live, pz, oz)
    dx = torch.where(live, ndx, dx)
    dy = torch.where(live, ndy, dy)
    dz = torch.where(live, ndz, dz)
    return [ox, oy, oz, dx, dy, dz, tm, thr_r, thr_g, thr_b, rad_r, rad_g, rad_b, live]


def state_out(st):
    """The ray state list as ``(rad (3, n), state (N_F, n))``."""
    rad = torch.stack(st[RR:RB + 1])
    return rad, torch.stack([*st[:ACT], st[ACT].to(torch.float32)])


def trace_block_torch(mega, ray_f, ray_i: torch.Tensor, seed: int,
                      b_off: int, *, max_depth: int, background,
                      want_state: bool = True, want_ids: bool = False,
                      depth_cap=None, dep=None, camera=None, alive=None):
    """Plain PyTorch K1 with the kernel's inputs, outputs and arithmetic
    (each multiply and add rounded on its own, as the kernel is built with
    ``-fmad=false``). Runs on any device. A camera start (``camera``,
    ``ray_f`` None) packs ``camera.rays`` with :func:`pack_rays`."""
    if (dep is None) != (depth_cap is None):
        raise ValueError("pass dep exactly when depth_cap is set")
    _media_options(mega, want_ids, depth_cap)
    if camera is not None:
        pix, smp = ray_i[PIX], ray_i[SMP]
        ray_f = pack_rays(*camera.rays(pix, smp, seed), pix, smp, alive)[0]
    st = list(ray_f.unbind(0))
    st[ACT] = st[ACT] > 0.5
    pix, smp = ray_i[PIX], ray_i[SMP]
    bounces = torch.zeros(ray_f.shape[1], dtype=torch.int32, device=ray_f.device)
    ids = (torch.full((max_depth, ray_f.shape[1]), -1, dtype=torch.int32, device=ray_f.device)
           if want_ids else None)
    scatters = torch.zeros((), dtype=torch.int64, device=ray_f.device)
    for b in range(max_depth):
        active = st[ACT]
        if not bool(active.any()):
            break
        t, ib = _closest_hit(mega, *st[OX:TM + 1])
        if mega.n_media:
            t, ib = _media_hit(mega, st, t, ib, b, b_off, seed, pix, smp)
            scatters += (active & (ib <= -2)).sum()
        if want_ids:
            ids[b] = torch.where(active & (t < BIG), mega.kid_map[ib.clamp(min=0)], -1)
        st = shade(mega, st, t, ib, b, b_off, seed, pix, smp, background, dep, depth_cap)
        bounces = bounces + active.to(torch.int32)
    if mega.n_media:
        medium_scatters.tensor(ray_f.device).add_(scatters)

    rad, state = state_out(st)
    if not want_state:
        state = None
    return (rad, bounces, state, ids) if want_ids else (rad, bounces, state)
