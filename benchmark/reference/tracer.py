"""The plain reference path tracer and its gradient, in PyTorch.

It follows Ray Tracing in One Weekend / The Next Week: camera rays with
pixel jitter, a defocus disk and a shutter time; the closest hit by brute
force over every sphere (moving ones at the ray's time) and every quad;
lambertian, fuzzy metal, dielectric (Schlick's Fresnel coin) and diffuse
light; a constant background on a miss; at most ``depth`` segments a
path. With many spheres the search tests only those in the padded boxes
that a ray meets (:class:`SphereGroups`); it finds the same winner and
root as testing all of them, since a root is the same arithmetic on the
same pair either way. Its draws are those of ``rng.py``, so the same (pixel, sample,
seed) traces the same path as the renderer under test, up to rounding.
It imports nothing of the renderer: the scene comes from the
configuration's own recipe.

``dtype`` is the precision of every float tensor: float32 is the
reference, bfloat16 the lower-precision control.

Gradients (:func:`grad_sweep`) are those of the per-chunk MSE loss
against a black image with respect to the sphere centres and the texture
colours, with each path's discrete decisions (the primitive hit, the
checker cell, the Fresnel coin, absorption) held fixed: the closest hit
is searched without autograd and its distance recomputed with it.
"""
from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import torch

from . import rng
from .scene import CHECKER, DIELECTRIC, LIGHT, METAL, SceneTables

T_MIN = 1e-3          # roots at t <= T_MIN are rejected (shadow acne)
PARALLEL_EPS = 1e-8   # |n·d| below this: the ray runs parallel to a quad
NEAR_ZERO = 1e-8      # a lambertian direction this close to 0 falls back to the normal
SWEEP_ELEMENTS = 1 << 24  # (rays × spheres) elements of one step of the brute-force search
GROUP_SIZE = 16       # spheres in a group of the culled search
GROUP_MIN = 64        # spheres from which the search culls by groups
BIG_RADIUS = 0.5      # spheres larger than this are tested against every ray
BOX_PAD = 0.05        # a group's box is padded by this much on every side
CULL_RAYS = 1 << 19   # rays in one step of the culled search
GRAD_RAYS = 1 << 24   # rays of the chunks a gradient sweep traces together
NO_HIT = torch.iinfo(torch.int64).max


def load_config(path) -> tuple[dict, dict]:
    """A configuration's JSON and the tables its recipe (the ``recipe``
    file beside it) builds."""
    path = Path(path)
    conf = json.loads(path.read_text())
    spec = importlib.util.spec_from_file_location(f"recipe_{conf['name']}",
                                                  path.parent / conf["recipe"])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tables = SceneTables()
    mod.build(conf, tables)
    return conf, tables.arrays()


class Scene:
    """The tables as tensors on ``device`` in ``dtype``. While gradients
    are taken, ``leaves`` holds float64 copies of ``center`` and ``rgb``
    that require grad, from which the trace gathers its rows (see
    :meth:`rows`)."""

    def __init__(self, arrays: dict, device, dtype=torch.float32):
        f = lambda x: torch.as_tensor(x, device=device).to(dtype)  # noqa: E731
        i = lambda x: torch.as_tensor(x, device=device, dtype=torch.int64)  # noqa: E731
        self.dtype, self.device = dtype, device
        self.center, self.velocity = f(arrays["sph_center"]), f(arrays["sph_velocity"])
        self.radius = f(arrays["sph_radius"])
        self.r2 = f(arrays["sph_radius"] * arrays["sph_radius"])
        self.sph_mat = i(arrays["sph_mat"])
        self.n_sph = len(arrays["sph_radius"])
        self.moving = bool(np.any(arrays["sph_velocity"] != 0))
        # the quads' planes, as the book derives them from (q, u, v)
        n = np.cross(arrays["quad_u"], arrays["quad_v"]).astype(np.float32)
        nn = (n * n).sum(-1)
        unit = n / np.sqrt(nn)[:, None]
        self.q_n, self.q_w = f(unit), f(n / nn[:, None])
        self.q_d = f((unit * arrays["quad_q"]).sum(-1))
        self.q_q, self.q_u, self.q_v = (f(arrays[k]) for k in ("quad_q", "quad_u", "quad_v"))
        self.quad_mat = i(arrays["quad_mat"])
        self.n_quad = len(arrays["quad_mat"])
        self.mat_type, self.mat_tex = i(arrays["mat_type"]), i(arrays["mat_tex"])
        self.mat_fuzz, self.mat_ior = f(arrays["mat_fuzz"]), f(arrays["mat_ior"])
        self.tex_type, self.tex_child = i(arrays["tex_type"]), i(arrays["tex_child"])
        self.tex_scale, self.rgb = f(arrays["tex_scale"]), f(arrays["tex_rgb"])
        # culled only in float32, where a test shows it equal to brute force
        self.groups = (SphereGroups(arrays, device)
                       if self.n_sph >= GROUP_MIN and dtype == torch.float32 else None)
        self.leaves = None

    def rows(self, name: str, idx):
        """Rows ``idx`` of the table ``name`` (``center`` or ``rgb``) in
        ``dtype``: the same values whether or not gradients are taken, but
        then gathered from the float64 leaf, so that the backward sums the
        rays' cotangents of a row in float64."""
        if self.leaves is not None:
            return self.leaves[name][idx].to(self.dtype)
        return getattr(self, name)[idx]


class SphereGroups:
    """The spheres split for the culled search: the large ones (tested
    against every ray), and the rest in groups of at most ``GROUP_SIZE``
    by a median split of their centres along their widest axis, each
    group with a box that holds its spheres over the whole shutter,
    padded by ``BOX_PAD``."""

    def __init__(self, arrays: dict, device):
        c = np.asarray(arrays["sph_center"], np.float64)
        c1 = c + np.asarray(arrays["sph_velocity"], np.float64)
        r = np.asarray(arrays["sph_radius"], np.float64)
        big = np.flatnonzero(r > BIG_RADIUS)
        leaves = []

        def split(ids):
            if len(ids) <= GROUP_SIZE:
                leaves.append(ids)
                return
            axis = int(np.argmax(np.ptp(c[ids], axis=0)))
            ids = ids[np.argsort(c[ids, axis], kind="stable")]
            split(ids[:len(ids) // 2])
            split(ids[len(ids) // 2:])

        split(np.flatnonzero(r <= BIG_RADIUS))
        members = np.zeros((len(leaves), GROUP_SIZE), np.int64)
        valid = np.zeros((len(leaves), GROUP_SIZE), bool)
        lo = np.zeros((len(leaves), 3))
        hi = np.zeros((len(leaves), 3))
        for g, ids in enumerate(leaves):
            members[g, :len(ids)], valid[g, :len(ids)] = ids, True
            lo[g] = (np.minimum(c[ids], c1[ids]) - r[ids, None]).min(0) - BOX_PAD
            hi[g] = (np.maximum(c[ids], c1[ids]) + r[ids, None]).max(0) + BOX_PAD
        self.big = torch.as_tensor(big, device=device)
        self.members = torch.as_tensor(members, device=device)
        self.valid = torch.as_tensor(valid, device=device)
        self.lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
        self.hi = torch.as_tensor(hi, dtype=torch.float32, device=device)

    def met(self, o, d):
        """(n, G) bool: which groups' boxes each ray (float32 o, d) meets
        at some t >= 0."""
        d = torch.where(d == 0, 1e-30, d)
        t1 = (self.lo[None] - o[:, None]) / d[:, None]
        t2 = (self.hi[None] - o[:, None]) / d[:, None]
        near = torch.fmin(t1, t2).amax(dim=2)
        far = torch.fmax(t1, t2).amin(dim=2)
        return (far >= 0) & (near <= far)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _safe_sqrt(x):
    """sqrt with a finite gradient at 0 (a root at exactly 0 would meet an
    infinite derivative times a zero cotangent)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))), 0.0)


class Camera:
    """The book's camera: a viewport at ``focus_dist`` along the view
    direction, pixel centres at ``pixel00 + i·du + j·dv``, and a defocus
    disk of half-angle ``defocus_angle / 2``."""

    def __init__(self, cam: dict, width: int, device, dtype=torch.float32):
        t = lambda x: torch.tensor(x, dtype=dtype, device=device)  # noqa: E731
        self.width = width
        self.height = max(1, int(width / cam["aspect_ratio"]))
        self.background = t(cam["background"])
        self.defocus = cam["defocus_angle"] > 0.0
        lookfrom, lookat, vup = t(cam["lookfrom"]), t(cam["lookat"]), t(cam["vup"])
        focus = t(cam["focus_dist"])
        h = torch.tan(t(cam["vfov"]) * (math.pi / 180.0) / 2.0)
        vh = 2.0 * h * focus
        vw = vh * (width / self.height)
        unit = lambda v: v / torch.sqrt(torch.sum(v * v))  # noqa: E731
        w = unit(lookfrom - lookat)
        u = unit(torch.linalg.cross(vup, w))
        v = torch.linalg.cross(w, u)
        view_u, view_v = vw * u, vh * (-v)
        self.du, self.dv = view_u / width, view_v / self.height
        upper_left = lookfrom - focus * w - view_u / 2 - view_v / 2
        self.pixel00 = upper_left + 0.5 * (self.du + self.dv)
        self.center = lookfrom
        radius = focus * torch.tan(t(cam["defocus_angle"]) * (math.pi / 180.0) / 2.0)
        self.disk_u, self.disk_v = u * radius, v * radius

    def rays(self, pix, smp, seed: int, moving: bool):
        """(origin, direction, time) of samples ``smp`` of pixels ``pix``
        (int64, row-major pixel index)."""
        dtype = self.du.dtype
        i = (pix % self.width).to(dtype)
        j = torch.div(pix, self.width, rounding_mode="floor").to(dtype)
        u4 = rng.uniforms(pix, smp, rng.STREAM_RAYGEN, seed, dtype)
        target = (self.pixel00[None] + (i + (u4[:, 0] - 0.5))[:, None] * self.du[None]
                  + (j + (u4[:, 1] - 0.5))[:, None] * self.dv[None])
        if self.defocus:
            r = torch.sqrt(u4[:, 2])
            th = (2.0 * math.pi) * u4[:, 3]
            origin = (self.center[None] + (r * torch.cos(th))[:, None] * self.disk_u[None]
                      + (r * torch.sin(th))[:, None] * self.disk_v[None])
        else:
            origin = self.center[None].expand(target.shape)
        if moving:
            time = rng.uniforms(pix, smp, rng.STREAM_TIME, seed, dtype)[:, 0]
        else:
            time = torch.zeros(pix.shape, dtype=dtype, device=pix.device)
        return origin, target - origin, time


def _sphere_s(sc: Scene, o, d, tm, a, cx, cy, cz, vx, vy, vz, r2):
    """Roots in a·t space (a = |d|²) of rays against spheres broadcast
    against them, +inf where none lies beyond T_MIN."""
    ocx = (o[..., 0] - cx) - tm * vx
    ocy = (o[..., 1] - cy) - tm * vy
    ocz = (o[..., 2] - cz) - tm * vz
    half_b = ocx * d[..., 0] + ocy * d[..., 1] + ocz * d[..., 2]
    cq = ocx * ocx + ocy * ocy + (ocz * ocz - r2)
    disc = half_b * half_b - a * cq
    sq = _safe_sqrt(disc)
    ta = T_MIN * a
    s0, s1 = -half_b - sq, -half_b + sq
    s = torch.where(s0 > ta, s0, s1)
    return torch.where((disc >= 0) & (s > ta), s, math.inf)


def _quad_t(sc: Scene, o, d, nx, ny, nz, dconst, qx, qy, qz, ux, uy, uz, vx, vy, vz, wx, wy,
            wz):
    """Plane distances of rays against quads, +inf off the quad or at t <= T_MIN."""
    ox, oy, oz, dx, dy, dz = o[..., 0], o[..., 1], o[..., 2], d[..., 0], d[..., 1], d[..., 2]
    denom = nx * dx + ny * dy + nz * dz
    safe = torch.where(torch.abs(denom) < PARALLEL_EPS, torch.ones_like(denom), denom)
    t = (dconst - (nx * ox + ny * oy + nz * oz)) / safe
    px, py, pz = ox + t * dx - qx, oy + t * dy - qy, oz + t * dz - qz
    alpha = wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz) + wz * (px * vy - py * vx)
    beta = wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz) + wz * (ux * py - uy * px)
    ok = ((torch.abs(denom) >= PARALLEL_EPS) & (t > T_MIN) & (alpha >= 0) & (alpha <= 1)
          & (beta >= 0) & (beta <= 1))
    return torch.where(ok, t, math.inf)


def _quad_cols(sc: Scene, idx=None):
    cols = [sc.q_n[:, 0], sc.q_n[:, 1], sc.q_n[:, 2], sc.q_d, *sc.q_q.T, *sc.q_u.T, *sc.q_v.T,
            *sc.q_w.T]
    return [c if idx is None else c[idx] for c in cols]


@torch.no_grad()
def closest(sc: Scene, o, d, tm):
    """(sphere index or -1, quad index or -1, t) of every ray's closest
    hit: the nearest sphere root (by brute force, or culled by groups where
    the scene has them), the lowest index among equal ones, and a quad only
    where strictly nearer."""
    n = o.shape[0]
    dev = o.device
    win_s = torch.full((n,), -1, dtype=torch.int64, device=dev)
    t = torch.full((n,), math.inf, dtype=o.dtype, device=dev)
    a = _dot(d, d)
    if sc.groups is not None:
        for k in range(0, n, CULL_RAYS):
            sl = slice(k, k + CULL_RAYS)
            win_s[sl], t[sl] = _closest_culled(sc, o[sl], d[sl], tm[sl], a[sl])
    elif sc.n_sph:
        step = max(1, SWEEP_ELEMENTS // sc.n_sph)
        c = [x[None] for x in (*sc.center.T, *sc.velocity.T, sc.r2)]
        for k in range(0, n, step):
            sl = slice(k, k + step)
            s = _sphere_s(sc, o[sl, None], d[sl, None], tm[sl, None], a[sl, None], *c)
            smin, arg = torch.min(s, dim=1)
            hit = torch.isfinite(smin)
            win_s[sl] = torch.where(hit, arg, -1)
            t[sl] = torch.where(hit, smin * (1.0 / a[sl]), math.inf)
    win_q = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if sc.n_quad:
        step = max(1, SWEEP_ELEMENTS // sc.n_quad)
        cols = [x[None] for x in _quad_cols(sc)]
        for k in range(0, n, step):
            sl = slice(k, k + step)
            tq, arg = torch.min(_quad_t(sc, o[sl, None], d[sl, None], *cols), dim=1)
            better = tq < t[sl]
            win_q[sl] = torch.where(better, arg, -1)
            win_s[sl] = torch.where(better, -1, win_s[sl])
            t[sl] = torch.where(better, tq, t[sl])
    return win_s, win_q, t


def _keys(s, ids):
    """int64 keys that order (root, sphere index) pairs: a root's float32
    bits (monotone for roots >= 0) above the index; NO_HIT where none."""
    bits = s.float().view(torch.int32).to(torch.int64)
    return torch.where(torch.isfinite(s), (bits << 32) | ids, NO_HIT)


def _closest_culled(sc: Scene, o, d, tm, a):
    """(sphere index or -1, t) of each ray's nearest sphere root: the large
    spheres against every ray, then each group of spheres against the rays
    that meet its box; the least root, the lowest index among equal ones."""
    g = sc.groups
    cols = (*sc.center.T, *sc.velocity.T, sc.r2)
    key = _keys(_sphere_s(sc, o[:, None], d[:, None], tm[:, None], a[:, None],
                          *(x[g.big][None] for x in cols)), g.big[None]).amin(dim=1)
    ray, grp = g.met(o.float(), d.float()).nonzero(as_tuple=True)
    mem = g.members[grp]
    s = _sphere_s(sc, o[ray, None], d[ray, None], tm[ray, None], a[ray, None],
                  *(x[mem] for x in cols))
    s = torch.where(g.valid[grp], s, math.inf)
    key = key.scatter_reduce(0, ray, _keys(s, mem).amin(dim=1), "amin")
    hit = key != NO_HIT
    smin = (key >> 32).to(torch.int32).view(torch.float32).to(o.dtype)
    return (torch.where(hit, key & 0xFFFFFFFF, -1),
            torch.where(hit, smin * (1.0 / a), math.inf))


def _winner_t(sc: Scene, o, d, tm, win_s, win_q):
    """The closest hit's distance recomputed for the winners alone, by the
    search's arithmetic (equal to its result), with autograd."""
    a = _dot(d, d)
    t = torch.full(a.shape, math.inf, dtype=a.dtype, device=a.device)
    if sc.n_sph:
        sid = win_s.clamp(min=0)
        c, v = sc.rows("center", sid), sc.velocity[sid]
        s = _sphere_s(sc, o, d, tm, a, c[:, 0], c[:, 1], c[:, 2], v[:, 0], v[:, 1], v[:, 2],
                      sc.r2[sid])
        t = torch.where(win_s >= 0, s * (1.0 / a), t)
    if sc.n_quad:
        tq = _quad_t(sc, o, d, *_quad_cols(sc, win_q.clamp(min=0)))
        t = torch.where(win_q >= 0, tq, t)
    return t


def trace(sc: Scene, o, d, tm, pix, smp, seed: int, depth: int, background):
    """Radiance ``(n, 3)`` and segments ``(n,)`` of paths from rays
    (o, d, tm) with RNG identities (pix, smp). Differentiable in the
    scene's ``leaves`` when they are set and autograd records."""
    n = o.shape[0]
    dev, dtype = o.device, o.dtype
    grad = torch.is_grad_enabled() and sc.leaves is not None
    rad = torch.zeros((n, 3), dtype=dtype, device=dev)
    segs = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    thr = torch.ones((n, 3), dtype=dtype, device=dev)
    for b in range(depth):
        if idx.numel() == 0:
            break
        segs[idx] += 1
        win_s, win_q, t = closest(sc, o.detach(), d.detach(), tm)
        if grad:
            t = _winner_t(sc, o, d, tm, win_s, win_q)
        hit = (win_s >= 0) | (win_q >= 0)
        t = torch.where(hit, t, torch.zeros_like(t))
        p = o + t[:, None] * d
        sid, qid = win_s.clamp(min=0), win_q.clamp(min=0)
        is_q = win_q >= 0
        if sc.n_sph:
            ct = sc.rows("center", sid) + tm[:, None] * sc.velocity[sid]
            own = (p - ct) * (1.0 / sc.radius[sid])[:, None]
        else:
            own = torch.zeros_like(p)
        if sc.n_quad:
            own = torch.where(is_q[:, None], sc.q_n[qid], own)
        front = _dot(d, own) < 0
        nrm = own * torch.where(front, 1.0, -1.0).to(dtype)[:, None]
        mat = torch.where(is_q, sc.quad_mat[qid] if sc.n_quad else 0,
                          sc.sph_mat[sid] if sc.n_sph else 0)
        mtype, tex = sc.mat_type[mat], sc.mat_tex[mat]
        with torch.no_grad():
            ts = sc.tex_scale[tex][:, None]
            cells = torch.floor(ts * p.detach()).to(torch.int32).sum(dim=1)
        chk = sc.tex_type[tex] == CHECKER
        row = torch.where(chk, sc.tex_child[tex, (cells & 1).long()], tex)
        albedo = sc.rows("rgb", row)

        u = rng.uniforms(pix, smp, b * rng.N_STREAMS + rng.STREAM_SCATTER, seed, dtype)
        z = 1.0 - 2.0 * u[:, 0]
        rho = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = (2.0 * math.pi) * u[:, 1]
        ruv = torch.stack([rho * torch.cos(phi), rho * torch.sin(phi), z], dim=1)
        # lambertian
        lam = nrm + ruv
        degen = torch.all(torch.abs(lam) < NEAR_ZERO, dim=1)
        lam = torch.where(degen[:, None], nrm, lam)
        # metal
        refl = d - (2.0 * _dot(d, nrm))[:, None] * nrm
        met = (refl * (1.0 / torch.sqrt(_dot(refl, refl) + 1e-30))[:, None]
               + sc.mat_fuzz[mat][:, None] * ruv)
        metal_ok = _dot(met, nrm) > 0
        # dielectric
        ior = sc.mat_ior[mat]
        ud = d * (1.0 / torch.sqrt(_dot(d, d) + 1e-30))[:, None]
        ri = torch.where(front, 1.0 / ior, ior)
        cos = torch.clamp(-_dot(ud, nrm), max=1.0)
        sin = torch.sqrt(torch.clamp(1.0 - cos * cos, min=0.0))
        r0 = (1.0 - ri) / (1.0 + ri)
        r0 = r0 * r0
        x = 1.0 - cos
        x2 = x * x
        reflect = (ri * sin > 1.0) | (r0 + (1.0 - r0) * (x * (x2 * x2)) > u[:, 2])
        perp = ri[:, None] * (ud + cos[:, None] * nrm)
        par = -_safe_sqrt(torch.abs(1.0 - _dot(perp, perp)))
        die = torch.where(reflect[:, None], ud - (2.0 * _dot(ud, nrm))[:, None] * nrm,
                          perp + par[:, None] * nrm)

        is_metal, is_diel, is_light = mtype == METAL, mtype == DIELECTRIC, mtype == LIGHT
        new_d = torch.where(is_diel[:, None], die, torch.where(is_metal[:, None], met, lam))
        att = torch.where(is_diel[:, None], torch.ones_like(albedo), albedo)
        add = (torch.where((~hit)[:, None], thr * background[None], 0.0)
               + torch.where((hit & is_light)[:, None], thr * albedo, 0.0))
        rad = rad.index_add(0, idx, add) if grad else rad.index_add_(0, idx, add)
        live = hit & ((is_metal & metal_ok) | (~is_metal & ~is_light))
        idx, o, d, tm = idx[live], p[live], new_d[live], tm[live]
        thr, pix, smp = (thr * att)[live], pix[live], smp[live]
    return rad, segs


def render_pixels(sc: Scene, cam: Camera, pixels, spp: int, depth: int, seed: int,
                  batch: int = 1 << 18):
    """Mean radiance ``(P, 3)`` (float32) and segments ``(P,)`` of the
    ``pixels`` (int64 row-major ids), each over samples ``0 .. spp - 1``."""
    pixels = pixels.to(sc.device)
    P = pixels.shape[0]
    rad = torch.zeros((P, 3), dtype=torch.float64, device=sc.device)
    segs = torch.zeros(P, dtype=torch.int64, device=sc.device)
    per = max(1, batch // spp)
    with torch.no_grad():
        for k in range(0, P, per):
            pk = pixels[k:k + per]
            pix = pk.repeat_interleave(spp)
            smp = torch.arange(spp, device=sc.device).repeat(pk.shape[0])
            o, d, tm = cam.rays(pix, smp, seed, sc.moving)
            r, s = trace(sc, o, d, tm, pix, smp, seed, depth, cam.background)
            rad[k:k + per] = r.double().reshape(-1, spp, 3).sum(dim=1)
            segs[k:k + per] = s.reshape(-1, spp).sum(dim=1)
    return (rad / spp).float(), segs


def grad_sweep(sc: Scene, cam: Camera, spp: int, spp_chunk: int, depth: int, seed: int):
    """The gradient sweep: for every chunk of ``spp_chunk`` samples of
    every pixel, the MSE of the chunk's mean image against black and its
    gradient with respect to sphere centres and texture colours; summed
    over the chunks. Chunks are traced together, as many as ``GRAD_RAYS``
    rays hold, and differentiated as the sum of their losses; every sum over
    rays or chunks runs in float64. Returns float32 ``(loss, g_center (N,
    3), g_rgb (T, 3), segments)``."""
    n_pix = cam.width * cam.height
    per = max(1, GRAD_RAYS // (n_pix * spp_chunk))  # chunks traced together
    center = sc.center.double().requires_grad_(True)
    rgb = sc.rgb.double().requires_grad_(True)
    sc.leaves = {"center": center, "rgb": rgb}
    loss = torch.zeros((), dtype=torch.float64, device=sc.device)
    g_c = torch.zeros(center.shape, dtype=torch.float64, device=sc.device)
    g_r = torch.zeros(rgb.shape, dtype=torch.float64, device=sc.device)
    segs = 0
    try:
        for s0 in range(0, spp, spp_chunk * per):
            k = min(per, (spp - s0) // spp_chunk)
            pix = torch.arange(n_pix, device=sc.device).repeat(spp_chunk * k)
            smp = s0 + torch.arange(spp_chunk * k, device=sc.device).repeat_interleave(n_pix)
            with torch.no_grad():
                o, d, tm = cam.rays(pix, smp, seed, sc.moving)
            with torch.enable_grad():
                rad, s = trace(sc, o, d, tm, pix, smp, seed, depth, cam.background)
                img = rad.reshape(k, spp_chunk, n_pix, 3).mean(dim=1)
                lc = torch.mean(img * img, dim=(1, 2))
                gc, gr = torch.autograd.grad(lc.sum(), (center, rgb), allow_unused=True)
            loss += lc.detach().double().sum()
            g_c += gc if gc is not None else 0.0
            g_r += gr if gr is not None else 0.0
            segs += int(s.sum())
    finally:
        sc.leaves = None
    return loss.float(), g_c.float(), g_r.float(), segs
