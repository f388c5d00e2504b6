"""K5, the group megakernel: one phase of up to ``max_depth`` bounces for
every ray of a launch, with the closest hit from an in-kernel walk of the
chunked BVH or from a dense sweep of the unified table. It replaces the
Pallas kernel ``raytracing_tpu/ops/megakernel.py`` ``make_megakernel``.

Closest hit, per bounce and ray:

* the walk (``use_bvh=True``): a stackless preorder walk over the nodes of
  ``ops/mega_bvh.py`` from the root. A box is hit when ``enter < exit``,
  with ``enter`` clamped below by ``T_MIN`` and ``exit`` above by the
  best hit so far; an internal node that is hit descends to ``i + 1``,
  anything else follows its skip link. A leaf that is hit tests its 8
  members at once: the smallest candidate wins, the lowest unified column
  among equal candidates, and it replaces the best hit only when strictly
  nearer;
* the dense sweep (``use_bvh=False``): chunks of 8 columns of the unified
  table, spheres and then quads, with the lowest column winning ties in a
  chunk and strict ``<`` across chunks.

Both test a sphere with its center at the ray's time and its roots in t
space, and a quad through its plane, w and edges. The shading after the
hit is K1's (``megakernel_block.shade``): background, resolve, solid,
checker, marble or image albedo, lambertian, metal, dielectric or light,
PCG4D keyed on (pix, smp, (b + b_off)·4 + 2, seed). As in the JAX
package, K5 has no depth cap.

Two implementations compute it:

* ``csrc/megakernel_group.cu``, a CUDA C++ kernel for sm_90a, one thread
  per ray (see the note at the top of that file);
* :func:`trace_group_torch`, the plain PyTorch version, vectorized over
  rays: the walk moves every live ray one node per step in lockstep.

:func:`trace_group` is the wrapper: tensors on the CPU go to the plain
version, tensors on a CUDA device launch the kernel, anything else
raises. Each kernel launch adds one to :data:`launches`.
:func:`trace_group_probe` launches the kernel's measurement probe (the
walk in K5's design or in the baseline design, timed or as a counting
instantiation for the lanes a warp keeps busy); tools and
``chip_smoke.py`` call it, never a render. Ray state and
outputs are K1's (``megakernel_block``): ``ray_f (N_F, n) f32`` and
``ray_i (2, n) i32`` in; ``rad (3, n)``, ``bounces (n,) i32`` and, with
``want_state``, the new ``ray_f`` out.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from ..scene import flatten as fl
from . import megakernel_block as mb
from .intersect import PARALLEL_EPS, T_MIN, sqrt_rn

BIG = mb.BIG
SAFE_INV_EPS = 1e-20  # |direction| floor of the slab test's reciprocals
NO_GID = 2 ** 31 - 1  # above every unified column: loses every gid tie
# columns of the unified table per vectorized step of the plain sweep (a
# multiple of 8: see _sweep)
PLAIN_CHUNK = 128

launches = _kernels.LaunchCount()  # K5 kernel launches (plain-version calls excluded)
# the probe's designs (csrc/megakernel_group.cu rt_trace_group_probe): the
# baseline (one loop, the root of max(disc, 0)) and K5's (the guarded root
# and the node/leaf loop split, what trace_group runs)
DESIGNS = ("baseline", "guard+split")
K5_DESIGN = "guard+split"
# the probe's counts: node visits, sphere and quad member tests, box-test
# warp issues and their active lanes, member-test issues and their lanes
PROBE_COUNTS = ("visits", "sphere_tests", "quad_tests", "box_issues", "box_lanes",
                "member_issues", "member_lanes")


def _refuse_media(mega):
    if mega.n_media:
        raise ValueError(f"K5 does not trace participating media, and this scene has "
                         f"{mega.n_media}: trace it through K1 (the block layout)")


def _check(mega, ray_f, ray_i):
    _refuse_media(mega)
    n = ray_f.shape[1]
    if ray_f.shape != (mb.N_F, n) or ray_f.dtype != torch.float32:
        raise ValueError(f"ray_f must be ({mb.N_F}, n) float32, got {tuple(ray_f.shape)} {ray_f.dtype}")
    if ray_i.shape != (2, n) or ray_i.dtype != torch.int32:
        raise ValueError(f"ray_i must be (2, n) int32, got {tuple(ray_i.shape)} {ray_i.dtype}")
    tables = (mega.table, mega.nodes, mega.sph_leaf, mega.sph_gid, mega.quad_leaf,
              mega.quad_gid, mega.perm, mega.grad, mega.atlas)
    if any(t.device != ray_f.device for t in (ray_i, *tables)):
        raise ValueError("scene tables and ray state must be on one device")
    return tables


def trace_group(mega, ray_f: torch.Tensor, ray_i: torch.Tensor, seed: int, b_off: int, *,
                max_depth: int, background, use_bvh: bool, want_state: bool = True):
    """Trace one phase of ``max_depth`` bounces. Returns ``(rad (3, n),
    bounces (n,) i32, state (N_F, n) or None)``."""
    tables = _check(mega, ray_f, ray_i)
    dev = ray_f.device
    if dev.type == "cpu":
        return trace_group_torch(mega, ray_f, ray_i, seed, b_off, max_depth=max_depth,
                                 background=background, use_bvh=use_bvh,
                                 want_state=want_state)
    if dev.type != "cuda":
        raise ValueError(f"K5 runs on CUDA tensors (kernel) or CPU tensors (plain version), not {dev}")
    if not all(t.is_contiguous() for t in (ray_f, ray_i, *tables)):
        raise ValueError("K5 needs contiguous tensors")
    n = ray_f.shape[1]
    if n >= 2 ** 31 // mb.N_F or mega.table.numel() >= 2 ** 31:
        raise ValueError(f"K5 launch of {n} rays exceeds its 32-bit indexing")

    lib = _kernels.library().lib
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    bounces = torch.empty((n,), dtype=torch.int32, device=dev)
    state = torch.empty((mb.N_F, n), dtype=torch.float32, device=dev) if want_state else None
    if n == 0:
        return rad, bounces, state
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rt_trace_group(
            *_group_args(mega, ray_f, ray_i, rad, bounces, state, seed, b_off, max_depth,
                         background),
            int(bool(use_bvh)), int(mega.has_noise), int(mega.has_image),
            mega.perm.data_ptr(), mega.grad.data_ptr(), mega.atlas.data_ptr(), stream)
    launches.add(dev)
    if err != 0:
        raise RuntimeError(f"K5 launch failed: {lib.rt_error_string(err).decode()}")
    return rad, bounces, state


def _group_args(mega, ray_f, ray_i, rad, bounces, state, seed, b_off, max_depth, background):
    """The leading arguments of both C entry points."""
    n = ray_f.shape[1]
    return (mega.table.data_ptr(), mega.n_prims, mega.n_sph_pad,
            mega.nodes.data_ptr(), mega.nodes.shape[0],
            mega.sph_leaf.data_ptr(), mega.sph_gid.data_ptr(), mega.n_sph_chunks,
            mega.quad_leaf.data_ptr(), mega.quad_gid.data_ptr(),
            ray_f.data_ptr(), ray_i.data_ptr(), n,
            rad.data_ptr(), bounces.data_ptr(), state.data_ptr() if state is not None else None,
            ctypes.c_uint32(seed), ctypes.c_uint32(b_off), max_depth,
            float(background[0]), float(background[1]), float(background[2]))


def trace_group_probe(mega, ray_f: torch.Tensor, ray_i: torch.Tensor, seed: int, b_off: int, *,
                      max_depth: int, background, design: str = K5_DESIGN,
                      count: bool = False):
    """K5's measurement probe on CUDA tensors: the walk by ``design``
    (:data:`DESIGNS`), on a scene without marble or image textures whose
    node table shared memory holds. Returns ``(rad (3, n), bounces (n,)
    i32, state (N_F, n), counts)``, the first three as :func:`trace_group`'s:
    with ``count`` the counting instantiation runs and ``counts`` is a dict
    over :data:`PROBE_COUNTS` summed over the launch, else None. Does not
    add to :data:`launches`."""
    tables = _check(mega, ray_f, ray_i)
    dev = ray_f.device
    if dev.type != "cuda":
        raise ValueError(f"the K5 probe runs on CUDA tensors only, not {dev}")
    if mega.has_noise or mega.has_image:
        raise ValueError("the K5 probe takes scenes without marble or image textures")
    if not all(t.is_contiguous() for t in (ray_f, ray_i, *tables)):
        raise ValueError("K5 needs contiguous tensors")
    lib = _kernels.library().lib
    n = ray_f.shape[1]
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    bounces = torch.empty((n,), dtype=torch.int32, device=dev)
    state = torch.empty((mb.N_F, n), dtype=torch.float32, device=dev)
    cnt = torch.zeros(len(PROBE_COUNTS), dtype=torch.int64, device=dev) if count else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rt_trace_group_probe(
            *_group_args(mega, ray_f, ray_i, rad, bounces, state, seed, b_off, max_depth,
                         background),
            DESIGNS.index(design), cnt.data_ptr() if count else None, stream)
    if err != 0:
        raise RuntimeError(f"K5 probe ({design}, count={count}) failed: "
                           f"{lib.rt_error_string(err).decode()}")
    counts = dict(zip(PROBE_COUNTS, cnt.tolist())) if count else None
    return rad, bounces, state, counts


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _sphere_cand(cx0, cy0, cz0, vx, vy, vz, r, ox, oy, oz, dx, dy, dz, tm, a, inv_a, tb):
    """Each sphere's nearest root in (T_MIN, tb), or BIG. Primitives on
    the last axis, rays on the first (ray arguments are ``(m, 1)``)."""
    ocx = ox - (cx0 + tm * vx)
    ocy = oy - (cy0 + tm * vy)
    ocz = oz - (cz0 + tm * vz)
    half_b = ocx * dx + ocy * dy + ocz * dz
    cq = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r
    disc = half_b * half_b - a * cq
    # rounded as the kernel's sqrtf: a cancelling root (a ray grazing the
    # r = 1000 ground) turns an ulp of the sqrt into a last bit of t
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    root0 = (-half_b - sq) * inv_a
    root1 = (-half_b + sq) * inv_a
    ok0 = (root0 > T_MIN) & (root0 < tb)
    ok1 = (root1 > T_MIN) & (root1 < tb)
    root = torch.where(ok0, root0, root1)
    valid = (disc >= 0.0) & (ok0 | ok1) & (r > 0.0)
    return torch.where(valid, root, BIG)


def _quad_cand(q, ox, oy, oz, dx, dy, dz, tb):
    """Each quad's plane hit in (T_MIN, tb) inside its edges, or BIG.
    ``q`` holds 16 fields ``nx ny nz D wx wy wz qx qy qz ux uy uz vx vy
    vz``, each shaped like the candidates."""
    nx, ny, nz, dd, wx, wy, wz, qx, qy, qz, ux, uy, uz, vx, vy, vz = q
    denom = nx * dx + ny * dy + nz * dz
    safe = torch.where(torch.abs(denom) < PARALLEL_EPS, 1.0, denom)
    tq = (dd - (nx * ox + ny * oy + nz * oz)) / safe
    px = ox + tq * dx - qx
    py = oy + tq * dy - qy
    pz = oz + tq * dz - qz
    alpha = (wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz)
             + wz * (px * vy - py * vx))
    beta = (wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz)
            + wz * (ux * py - uy * px))
    valid = ((torch.abs(denom) >= PARALLEL_EPS) & (tq > T_MIN) & (tq < tb)
             & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0))
    return torch.where(valid, tq, BIG)


_QUAD_TABLE_ROWS = [fl.U_G0, fl.U_G1, fl.U_G2, fl.U_G3, fl.U_G4, fl.U_G5, fl.U_G6,
                    fl.U_QX, fl.U_QY, fl.U_QZ, fl.U_UX, fl.U_UY, fl.U_UZ,
                    fl.U_VX, fl.U_VY, fl.U_VZ]


def _sweep(mega, ox, oy, oz, dx, dy, dz, tm):
    """Dense closest hit over every unified-table column: (t, ib), BIG and
    -1 on a miss.

    The JAX kernel takes chunks of 8 in turn, each chunk's candidates held
    against the best hit at the chunk's start; a candidate is a root below
    that best hit, and the nearest root above T_MIN of a primitive does
    not depend on the best hit otherwise. So the result is the smallest
    root over all columns with the lowest column among equals, whatever
    the step: this version takes PLAIN_CHUNK columns per step, spheres and
    quads apart, with the lowest column winning a step's ties
    (``torch.min``) and strict ``<`` across steps."""
    a = dx * dx + dy * dy + dz * dz
    inv_a = (1.0 / a)[:, None]
    n = ox.shape[0]
    tb = torch.full((n,), BIG, dtype=torch.float32, device=ox.device)
    ib = torch.full((n,), -1, dtype=torch.int64, device=ox.device)
    r_ = [x[:, None] for x in (ox, oy, oz, dx, dy, dz, tm)]
    rox, roy, roz, rdx, rdy, rdz, rtm = r_
    tab = mega.table
    ns_pad, P = mega.n_sph_pad, mega.n_prims
    for j0, j1 in _sweep_steps(ns_pad, P):
        cols = tab[:, j0:j1]
        if j0 < ns_pad:
            cand = _sphere_cand(*(cols[f] for f in (fl.U_G0, fl.U_G1, fl.U_G2, fl.U_G3,
                                                    fl.U_G4, fl.U_G5, fl.U_G6)),
                                rox, roy, roz, rdx, rdy, rdz, rtm, a[:, None], inv_a,
                                tb[:, None])
        else:
            cand = _quad_cand([cols[f] for f in _QUAD_TABLE_ROWS], rox, roy, roz, rdx, rdy,
                              rdz, tb[:, None])
        cmin, arg = torch.min(cand, dim=1)  # first index among equal minima
        imp = cmin < tb
        tb = torch.where(imp, cmin, tb)
        ib = torch.where(imp, arg + j0, ib)
    return tb, ib


def _sweep_steps(ns_pad: int, P: int):
    """(start, stop) column ranges of the plain sweep's steps: spheres,
    then quads, never both in one step."""
    return ([(j, min(j + PLAIN_CHUNK, ns_pad)) for j in range(0, ns_pad, PLAIN_CHUNK)]
            + [(j, min(j + PLAIN_CHUNK, P)) for j in range(ns_pad, P, PLAIN_CHUNK)])


def _leaf_hit(members, gid, tb, ib, cand):
    """Fold one leaf's candidates ``(m, 8)`` into the best hit of the rays
    ``members`` index: the smallest candidate, the lowest gid among equal
    ones, taken when strictly nearer."""
    cmin = cand.min(dim=1).values
    gsel = torch.where(cand == cmin[:, None], gid, NO_GID)
    gmin = gsel.min(dim=1).values
    t0 = tb[members]
    imp = cmin < t0
    tb[members] = torch.where(imp, cmin, t0)
    ib[members] = torch.where(imp, gmin.to(torch.int64), ib[members])


def _safe_inv(v):
    return torch.where(v < 0.0, -1.0, 1.0) / torch.clamp(torch.abs(v), min=SAFE_INV_EPS)


def real_members(gid: torch.Tensor) -> torch.Tensor:
    """Real members of each leaf chunk ``(L,)`` from its gids ``(L, 8)``:
    a short chunk's pad slots repeat its first gid (``mega_bvh``)."""
    return (gid[:, 1:] != gid[:, :1]).sum(1) + 1


def _walk(mega, ox, oy, oz, dx, dy, dz, tm, active, counts=None):
    """Closest hit by the lockstep BVH walk: (t, ib), BIG and -1 on a miss
    and for dead rays. ``counts``, when given, is a ``(3, n)`` int64 tensor
    that gains each ray's node visits and sphere and quad member tests (the
    real members of each leaf it tests, not its pad slots)."""
    n = ox.shape[0]
    dev = ox.device
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    ivx, ivy, ivz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    tb = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    ib = torch.full((n,), -1, dtype=torch.int64, device=dev)
    nodes = mega.nodes
    n_sc = mega.n_sph_chunks
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.nonzero(active & (nodes.shape[0] > 0)).flatten()  # rays on a node
    while idx.numel():
        g = nodes[node[idx]]
        o_x, o_y, o_z = ox[idx], oy[idx], oz[idx]
        t0x = (g[:, 0] - o_x) * ivx[idx]
        t1x = (g[:, 3] - o_x) * ivx[idx]
        t0y = (g[:, 1] - o_y) * ivy[idx]
        t1y = (g[:, 4] - o_y) * ivy[idx]
        t0z = (g[:, 2] - o_z) * ivz[idx]
        t1z = (g[:, 5] - o_z) * ivz[idx]
        enter = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                              torch.clamp(torch.minimum(t0z, t1z), min=T_MIN))
        exit_ = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                              torch.minimum(torch.maximum(t0z, t1z), tb[idx]))
        boxhit = enter < exit_
        leafc = g[:, 7].to(torch.int64)
        is_leaf = leafc >= 0
        nxt = torch.where(boxhit & ~is_leaf, node[idx] + 1, g[:, 6].to(torch.int64))
        node[idx] = nxt
        if counts is not None:
            counts[0, idx] += 1
        at_leaf = boxhit & is_leaf
        for quad in (False, True):
            sel = at_leaf & ((leafc >= n_sc) if quad else (leafc < n_sc))
            if not bool(sel.any()):
                continue
            m = idx[sel]
            c = leafc[sel] - (n_sc if quad else 0)
            r_ = [x[m][:, None] for x in (ox, oy, oz, dx, dy, dz)]
            if quad:
                rec = mega.quad_leaf[c]  # (k, 8, 16)
                cand = _quad_cand(rec.unbind(-1), *r_, tb[m][:, None])
                gid = mega.quad_gid[c]
            else:
                rec = mega.sph_leaf[c]   # (k, 8, 8)
                cand = _sphere_cand(*rec.unbind(-1)[:7], *r_, tm[m][:, None],
                                    a[m][:, None], inv_a[m][:, None], tb[m][:, None])
                gid = mega.sph_gid[c]
            _leaf_hit(m, gid, tb, ib, cand)
            if counts is not None:
                counts[2 if quad else 1, m] += real_members(gid)
        idx = idx[nxt >= 0]
    return tb, ib


def trace_group_torch(mega, ray_f: torch.Tensor, ray_i: torch.Tensor, seed: int, b_off: int, *,
                      max_depth: int, background, use_bvh: bool, want_state: bool = True,
                      want_counts: bool = False):
    """Plain PyTorch K5 with the kernel's inputs, outputs and arithmetic
    (each multiply and add rounded on its own, as the kernel is built with
    ``-fmad=false``). Runs on any device. With ``want_counts`` a fourth
    output, ``(3, n) int64``, holds each ray's node visits, sphere member
    tests and quad member tests over the phase, pads not counted (for the
    dense sweep: no visits, and every sphere and quad column once per
    segment)."""
    _refuse_media(mega)
    st = list(ray_f.unbind(0))
    st[mb.ACT] = st[mb.ACT] > 0.5
    pix, smp = ray_i[mb.PIX], ray_i[mb.SMP]
    n = ray_f.shape[1]
    bounces = torch.zeros(n, dtype=torch.int32, device=ray_f.device)
    counts = torch.zeros((3, n), dtype=torch.int64, device=ray_f.device) if want_counts else None
    for b in range(max_depth):
        active = st[mb.ACT]
        if not bool(active.any()):
            break
        if use_bvh:
            t, ib = _walk(mega, *st[mb.OX:mb.TM + 1], active, counts)
        else:
            t, ib = _sweep(mega, *st[mb.OX:mb.TM + 1])
            if counts is not None:
                counts[1] += active * mega.n_sph_pad
                counts[2] += active * (mega.n_prims - mega.n_sph_pad)
        st = mb.shade(mega, st, t, ib, b, b_off, seed, pix, smp, background)
        bounces = bounces + active.to(torch.int32)

    rad, state = mb.state_out(st)
    out = (rad, bounces, state if want_state else None)
    return (*out, counts) if want_counts else out
