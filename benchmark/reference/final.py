"""The plain reference for The Next Week's final scene (``next_week_final``),
beside ``tracer.py``: the same camera, draws and closest-hit arithmetic,
and what that scene adds to them.

* Textures: marble noise (Perlin tables drawn from ``perlin_seed`` as the
  book's ``perlin`` class draws them: 256 normalised uniform-cube gradients
  and three permutations, from ``numpy.random.default_rng``), and the
  nearest texel of an image (a sphere's (u, v) from its outward normal),
  read from a binary PPM with numpy and rounded through u8.
* Media: constant-density spheres tested against every ray after the
  surfaces (``constant_medium::hit``): both boundary roots, the entry
  clamped to T_MIN and the exit to the closest hit so far, and a free
  path -ln(u)/density, u lane k of the PCG4D draw at counter
  ``bounce * 4 + 3`` for medium k (the log in float64, rounded to the
  working precision); the medium wins where the entry plus the free path
  over |d| lies below its exit. It then scatters isotropically: the
  bounce's scatter draw as a unit vector, its albedo as attenuation.
* The closest hit is searched over the spheres and over the quads by
  groups of 16 (a median split of their boxes' centres), each group
  tested against the rays that meet its padded box; it finds every ray's
  winner and root as brute force does (a test holds them equal), since a
  root is the same arithmetic on the same pair either way.

It imports nothing of the program under test; ``dtype`` float32 is the
reference, bfloat16 the lower-precision control (searched by brute force).
"""
from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import torch

from . import rng, tracer
from .scene import CHECKER, DIELECTRIC, LIGHT, METAL, SceneTables

IMAGE, NOISE = 2, 3   # texture kinds beside SOLID and CHECKER
ISOTROPIC = 4         # a medium's phase function, beside the surface materials
STREAM_MEDIUM = 3     # lane k of this stream's draw is medium k's free path
MAX_MEDIA = 4
PERLIN_POINTS = 256
OCTAVES = 7           # marble turbulence depth
GROUP = 16            # primitives in a group of the culled search
# a group's box is padded by this much on every side: for a ray from as far
# as the fog's edge and beyond the scene (F <= 6,500), the rounded
# discriminant accepts a sphere of radius r >= 10 from at most
# 16 * 2^-25 * F^2 / r ~ 2 outside it; a quad's hit point is off by
# ~ |o| * 2^-22 ~ 0.01
SPHERE_PAD = 8.0
QUAD_PAD = 1.0


class FinalTables(SceneTables):
    """The recipe's tables, with image and noise textures and media.
    ``root``: the directory image paths are relative to."""

    def __init__(self, root):
        super().__init__()
        self.root = Path(root)
        self.images = []
        self.tex_image = []
        self.med_center, self.med_radius, self.med_density, self.med_mat = [], [], [], []

    def _tex(self, ttype, rgb=(0.0, 0.0, 0.0), scale=1.0, child=(0, 0), image=-1):
        self.tex_image.append(image)
        return super()._tex(ttype, rgb, scale, child)

    def noise(self, scale):
        return self._tex(NOISE, scale=scale)

    def image(self, path):
        self.images.append(read_ppm(self.root / path))
        return self._tex(IMAGE, image=len(self.images) - 1)

    def constant_medium(self, center, radius, density, albedo):
        self.med_center.append(np.asarray(center, np.float32))
        self.med_radius.append(np.float32(radius))
        self.med_density.append(np.float32(density))
        self.med_mat.append(self._mat(ISOTROPIC, self.solid(albedo)))

    def arrays(self) -> dict:
        out = super().arrays()
        out["tex_image"] = np.asarray(self.tex_image, np.int64)
        out["images"] = self.images
        out["med_center"] = np.asarray(self.med_center, np.float32).reshape(-1, 3)
        out["med_radius"] = np.asarray(self.med_radius, np.float32)
        out["med_density"] = np.asarray(self.med_density, np.float32)
        out["med_mat"] = np.asarray(self.med_mat, np.int64)
        return out


def read_ppm(path) -> np.ndarray:
    """A binary PPM (P6, maxval 255) as float32 texels in [0, 1], (H, W, 3)."""
    data = Path(path).read_bytes()
    tokens, i = [], 0
    while len(tokens) < 4:
        while data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            i = data.index(b"\n", i)
            continue
        j = i
        while not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    if tokens[0] != b"P6" or int(tokens[3]) != 255:
        raise ValueError(f"{path}: not a P6 PPM with maxval 255")
    w, h = int(tokens[1]), int(tokens[2])
    img = np.frombuffer(data, np.uint8, w * h * 3, i + 1).reshape(h, w, 3)
    return img.astype(np.float32) / np.float32(255.0)


def perlin_tables(seed: int):
    """(gradients (256, 3) float32, permutations (3, 256) int64)."""
    g = np.random.default_rng(seed)
    v = g.uniform(-1.0, 1.0, size=(PERLIN_POINTS, 3))
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    v = np.where(norms < 1e-12, 1.0, v / np.maximum(norms, 1e-12))
    perms = np.stack([g.permutation(PERLIN_POINTS) for _ in range(3)])
    return v.astype(np.float32), perms.astype(np.int64)


def load_config(path) -> tuple[dict, dict]:
    """The configuration's JSON and the tables its recipe builds, with the
    Perlin tables of its ``perlin_seed``."""
    path = Path(path)
    conf = json.loads(path.read_text())
    spec = importlib.util.spec_from_file_location(f"recipe_{conf['name']}",
                                                  path.parent / conf["recipe"])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tables = FinalTables(path.resolve().parents[2])
    mod.build(conf, tables)
    arrays = tables.arrays()
    arrays["perlin_vec"], arrays["perlin_perm"] = perlin_tables(conf["perlin_seed"])
    return conf, arrays


class BoxGroups:
    """Primitives split into groups of at most GROUP by a median split of
    their boxes' centres along the widest axis, each group with the union
    of its members' boxes, padded by ``pad``."""

    def __init__(self, lo: np.ndarray, hi: np.ndarray, pad: float, device):
        mid = 0.5 * (lo + hi)
        leaves = []

        def split(ids):
            if len(ids) <= GROUP:
                leaves.append(ids)
                return
            axis = int(np.argmax(np.ptp(mid[ids], axis=0)))
            ids = ids[np.argsort(mid[ids, axis], kind="stable")]
            split(ids[:len(ids) // 2])
            split(ids[len(ids) // 2:])

        split(np.arange(len(lo)))
        members = np.zeros((len(leaves), GROUP), np.int64)
        valid = np.zeros((len(leaves), GROUP), bool)
        glo, ghi = np.zeros((len(leaves), 3)), np.zeros((len(leaves), 3))
        for g, ids in enumerate(leaves):
            members[g, :len(ids)], valid[g, :len(ids)] = ids, True
            glo[g], ghi[g] = lo[ids].min(0) - pad, hi[ids].max(0) + pad
        self.members = torch.as_tensor(members, device=device)
        self.valid = torch.as_tensor(valid, device=device)
        self.lo = torch.as_tensor(glo, dtype=torch.float32, device=device)
        self.hi = torch.as_tensor(ghi, dtype=torch.float32, device=device)

    met = tracer.SphereGroups.met


class FinalScene:
    """The tables as tensors on ``device`` in ``dtype``, as ``tracer.Scene``
    holds them (no gradients), with the textures, the media and the
    groups of the culled search (float32 only; ``culled=False`` searches
    by brute force)."""

    def __init__(self, arrays: dict, device, dtype=torch.float32, culled: bool = True):
        f = lambda x: torch.as_tensor(x, device=device).to(dtype)  # noqa: E731
        i = lambda x: torch.as_tensor(x, device=device, dtype=torch.int64)  # noqa: E731
        self.dtype, self.device = dtype, device
        self.center, self.velocity = f(arrays["sph_center"]), f(arrays["sph_velocity"])
        self.radius = f(arrays["sph_radius"])
        self.r2 = f(arrays["sph_radius"] * arrays["sph_radius"])
        self.sph_mat = i(arrays["sph_mat"])
        self.n_sph = len(arrays["sph_radius"])
        self.moving = bool(np.any(arrays["sph_velocity"] != 0))
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
        self.groups = None  # tracer.closest's sphere groups: the search here has its own
        self.perlin_vec = f(arrays["perlin_vec"])
        self.perlin_perm = i(arrays["perlin_perm"])
        imgs = arrays["images"]
        self.atlas = f(np.concatenate([im.reshape(-1, 3) for im in imgs]) if imgs
                       else np.zeros((1, 3), np.float32))
        base = np.cumsum([0] + [im.shape[0] * im.shape[1] for im in imgs])[:-1]
        tex_img = arrays["tex_image"].clip(min=0)
        self.img_base = i(base[tex_img] if imgs else np.zeros_like(tex_img))
        self.img_w = i(np.asarray([im.shape[1] for im in imgs] or [1])[tex_img])
        self.img_h = i(np.asarray([im.shape[0] for im in imgs] or [1])[tex_img])
        self.n_med = len(arrays["med_radius"])
        if self.n_med > MAX_MEDIA:
            raise ValueError(f"at most {MAX_MEDIA} media")
        r = arrays["med_radius"]
        self.med_center, self.med_r2 = f(arrays["med_center"]), f(r * r)
        with np.errstate(divide="ignore"):
            self.med_nid = f(np.float32(-1.0) / arrays["med_density"])
        self.med_mat = i(arrays["med_mat"])
        self.sph_groups = self.quad_groups = None
        if culled and dtype == torch.float32:
            c = arrays["sph_center"].astype(np.float64)
            c1 = c + arrays["sph_velocity"]
            rad = arrays["sph_radius"].astype(np.float64)[:, None]
            if self.n_sph:
                self.sph_groups = BoxGroups(np.minimum(c, c1) - rad, np.maximum(c, c1) + rad,
                                            SPHERE_PAD, device)
            q, u, v = (arrays[k].astype(np.float64) for k in ("quad_q", "quad_u", "quad_v"))
            if self.n_quad:
                corners = np.stack([q, q + u, q + v, q + u + v])
                self.quad_groups = BoxGroups(corners.min(0), corners.max(0), QUAD_PAD, device)


def _culled(o, d, groups, test):
    """The least (distance, index) key of each ray over the members of the
    groups whose boxes it meets; ``test(rays, members)`` gives distances
    (inf where none)."""
    key = torch.full((o.shape[0],), tracer.NO_HIT, dtype=torch.int64, device=o.device)
    ray, grp = groups.met(o.float(), d.float()).nonzero(as_tuple=True)
    mem = groups.members[grp]
    s = torch.where(groups.valid[grp], test(ray, mem), math.inf)
    return key.scatter_reduce(0, ray, tracer._keys(s, mem).amin(dim=1), "amin")


def _unkey(key, dtype):
    hit = key != tracer.NO_HIT
    s = (key >> 32).to(torch.int32).view(torch.float32).to(dtype)
    return torch.where(hit, key & 0xFFFFFFFF, -1), torch.where(hit, s, math.inf)


@torch.no_grad()
def closest(sc: FinalScene, o, d, tm):
    """(sphere index or -1, quad index or -1, t): the nearest sphere root
    in a·t space (the lowest index among equal ones), then a quad only
    where strictly nearer; culled by groups where the scene has them."""
    if sc.sph_groups is None and sc.quad_groups is None:
        return tracer.closest(sc, o, d, tm)
    n = o.shape[0]
    win_s = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    win_q = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    t = torch.full((n,), math.inf, dtype=o.dtype, device=o.device)
    a = tracer._dot(d, d)
    cols_s = (*sc.center.T, *sc.velocity.T, sc.r2)
    cols_q = tracer._quad_cols(sc)
    for k in range(0, n, tracer.CULL_RAYS):
        sl = slice(k, k + tracer.CULL_RAYS)
        ok, dk, tk, ak = o[sl], d[sl], tm[sl], a[sl]
        if sc.n_sph:
            ws, s = _unkey(_culled(ok, dk, sc.sph_groups, lambda r, m: tracer._sphere_s(
                sc, ok[r, None], dk[r, None], tk[r, None], ak[r, None],
                *(x[m] for x in cols_s))), o.dtype)
            win_s[sl], t[sl] = ws, torch.where(ws >= 0, s * (1.0 / ak), math.inf)
        if sc.n_quad:
            wq, tq = _unkey(_culled(ok, dk, sc.quad_groups, lambda r, m: tracer._quad_t(
                sc, ok[r, None], dk[r, None], *(x[m] for x in cols_q))), o.dtype)
            better = (wq >= 0) & (tq < t[sl])
            win_q[sl] = torch.where(better, wq, -1)
            win_s[sl] = torch.where(better, -1, win_s[sl])
            t[sl] = torch.where(better, tq, t[sl])
    return win_s, win_q, t


def media(sc: FinalScene, o, d, t, pix, smp, b: int, seed: int):
    """(medium index or -1, t) after the media: medium k wins where its
    entry, clamped to T_MIN, plus its free path over |d| lies below its
    exit, clamped to the closest hit ``t`` so far (and below the media
    before it)."""
    win = torch.full(t.shape, -1, dtype=torch.int64, device=t.device)
    if not sc.n_med:
        return win, t
    a = tracer._dot(d, d)
    inv_a, length = 1.0 / a, torch.sqrt(a)
    words = rng.pcg4d(pix, smp, torch.full_like(pix, b * rng.N_STREAMS + STREAM_MEDIUM),
                      torch.full_like(pix, seed & rng._M))
    for k in range(sc.n_med):
        c = sc.med_center[k]
        ocx, ocy, ocz = o[:, 0] - c[0], o[:, 1] - c[1], o[:, 2] - c[2]
        half_b = ocx * d[:, 0] + ocy * d[:, 1] + ocz * d[:, 2]
        cq = ocx * ocx + ocy * ocy + (ocz * ocz - sc.med_r2[k])
        disc = half_b * half_b - a * cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t1 = torch.clamp((-half_b - sq) * inv_a, min=tracer.T_MIN)
        t2 = torch.minimum((-half_b + sq) * inv_a, t)
        u = (words[k] >> 8).to(torch.float64) * (1.0 / (1 << 24))
        free = sc.med_nid[k] * torch.log(u).to(t.dtype)
        tm = t1 + free / length
        ok = (disc >= 0) & (t1 < t2) & (tm < t2)
        win = torch.where(ok, k, win)
        t = torch.where(ok, tm, t)
    return win, t


def _atan2(y, x):
    """float32 atan2 that depends only on its inputs: on the card CUDA's,
    elsewhere a float64 one rounded."""
    if y.is_cuda:
        return torch.atan2(y, x)
    return torch.atan2(y.double(), x.double()).to(y.dtype)


def marble(sc: FinalScene, p, scale):
    """0.5·(1 + sin(scale·z + 10·turb(p))), turb the absolute sum of 7
    octaves 2^-k noise(2^k p) of Perlin gradient noise."""
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight, q = 1.0, p
    for _ in range(OCTAVES):
        fl = torch.floor(q)
        uvw = q - fl
        ijk = fl.to(torch.int64)
        h = uvw * uvw * (3.0 - 2.0 * uvw)
        acc = torch.zeros_like(accum)
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    perm = sc.perlin_perm
                    hash_ = (perm[0][(ijk[:, 0] + di) & 255] ^ perm[1][(ijk[:, 1] + dj) & 255]
                             ^ perm[2][(ijk[:, 2] + dk) & 255])
                    g = sc.perlin_vec[hash_]
                    dot = (g[:, 0] * (uvw[:, 0] - di) + g[:, 1] * (uvw[:, 1] - dj)
                           + g[:, 2] * (uvw[:, 2] - dk))
                    wx = h[:, 0] if di else 1.0 - h[:, 0]
                    wy = h[:, 1] if dj else 1.0 - h[:, 1]
                    wz = h[:, 2] if dk else 1.0 - h[:, 2]
                    acc = acc + wx * wy * wz * dot
        accum = accum + weight * acc
        weight *= 0.5
        q = q * 2.0
    return 0.5 * (1.0 + torch.sin(scale * p[:, 2] + 10.0 * torch.abs(accum)))


def image_albedo(sc: FinalScene, tex, own):
    """The nearest texel of image texture ``tex`` at a sphere's outward
    normal ``own``: θ = atan2(√(x²+z²), -y), φ = atan2(-z, x) + π (x taken
    as 1 on the poles), u = φ/2π, v = θ/π, then u and 1 - v scaled to the
    image and truncated."""
    x, y, z = own[:, 0], own[:, 1], own[:, 2]
    rxz = torch.sqrt(torch.clamp(x * x + z * z, min=0.0))
    theta = _atan2(rxz, -y)
    phi = _atan2(-z, torch.where(rxz > 0.0, x, 1.0)) + math.pi
    u, v = phi * (1.0 / (2.0 * math.pi)), theta * (1.0 / math.pi)
    w, h = sc.img_w[tex], sc.img_h[tex]
    ti = torch.minimum((torch.clamp(u, 0.0, 1.0) * w.to(u.dtype)).to(torch.int64), w - 1)
    tj = torch.minimum(((1.0 - torch.clamp(v, 0.0, 1.0)) * h.to(u.dtype)).to(torch.int64), h - 1)
    return sc.atlas[sc.img_base[tex] + tj.clamp(min=0) * w + ti.clamp(min=0)]


def trace(sc: FinalScene, o, d, tm, pix, smp, seed: int, depth: int, background):
    """Radiance ``(n, 3)``, segments ``(n,)`` and the media's scatters (an
    int) of paths from rays (o, d, tm) with RNG identities (pix, smp)."""
    n = o.shape[0]
    dev, dtype = o.device, o.dtype
    rad = torch.zeros((n, 3), dtype=dtype, device=dev)
    segs = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    thr = torch.ones((n, 3), dtype=dtype, device=dev)
    scatters = 0
    for b in range(depth):
        if idx.numel() == 0:
            break
        segs[idx] += 1
        win_s, win_q, t = closest(sc, o, d, tm)
        win_m, t = media(sc, o, d, t, pix, smp, b, seed)
        in_med = win_m >= 0
        win_s, win_q = torch.where(in_med, -1, win_s), torch.where(in_med, -1, win_q)
        hit = (win_s >= 0) | (win_q >= 0) | in_med
        scatters += int(in_med.sum())
        t = torch.where(hit, t, torch.zeros_like(t))
        p = o + t[:, None] * d
        sid, qid = win_s.clamp(min=0), win_q.clamp(min=0)
        is_q = win_q >= 0
        ct = sc.center[sid] + tm[:, None] * sc.velocity[sid]
        own = (p - ct) * (1.0 / sc.radius[sid])[:, None]
        if sc.n_quad:
            own = torch.where(is_q[:, None], sc.q_n[qid], own)
        front = tracer._dot(d, own) < 0
        nrm = own * torch.where(front, 1.0, -1.0).to(dtype)[:, None]
        mat = torch.where(is_q, sc.quad_mat[qid] if sc.n_quad else 0, sc.sph_mat[sid])
        if sc.n_med:
            mat = torch.where(in_med, sc.med_mat[win_m.clamp(min=0)], mat)
        mtype, tex = sc.mat_type[mat], sc.mat_tex[mat]
        ts = sc.tex_scale[tex][:, None]
        cells = torch.floor(ts * p).to(torch.int32).sum(dim=1)
        ttype = sc.tex_type[tex]
        row = torch.where(ttype == CHECKER, sc.tex_child[tex, (cells & 1).long()], tex)
        albedo = sc.rgb[row]
        sel = torch.nonzero(hit & (ttype == NOISE)).flatten()
        if sel.numel():
            albedo[sel] = marble(sc, p[sel], sc.tex_scale[tex[sel]])[:, None].expand(-1, 3)
        sel = torch.nonzero(hit & (ttype == IMAGE) & ~is_q).flatten()
        if sel.numel():
            albedo[sel] = image_albedo(sc, tex[sel], own[sel])

        u = rng.uniforms(pix, smp, b * rng.N_STREAMS + rng.STREAM_SCATTER, seed, dtype)
        z = 1.0 - 2.0 * u[:, 0]
        rho = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = (2.0 * math.pi) * u[:, 1]
        ruv = torch.stack([rho * torch.cos(phi), rho * torch.sin(phi), z], dim=1)
        lam = nrm + ruv
        lam = torch.where(torch.all(torch.abs(lam) < tracer.NEAR_ZERO, dim=1)[:, None], nrm, lam)
        refl = d - (2.0 * tracer._dot(d, nrm))[:, None] * nrm
        met = (refl * (1.0 / torch.sqrt(tracer._dot(refl, refl) + 1e-30))[:, None]
               + sc.mat_fuzz[mat][:, None] * ruv)
        metal_ok = tracer._dot(met, nrm) > 0
        ior = sc.mat_ior[mat]
        ud = d * (1.0 / torch.sqrt(tracer._dot(d, d) + 1e-30))[:, None]
        ri = torch.where(front, 1.0 / ior, ior)
        cos = torch.clamp(-tracer._dot(ud, nrm), max=1.0)
        sin = torch.sqrt(torch.clamp(1.0 - cos * cos, min=0.0))
        r0 = (1.0 - ri) / (1.0 + ri)
        r0 = r0 * r0
        x = 1.0 - cos
        x2 = x * x
        reflect = (ri * sin > 1.0) | (r0 + (1.0 - r0) * (x * (x2 * x2)) > u[:, 2])
        perp = ri[:, None] * (ud + cos[:, None] * nrm)
        par = -torch.sqrt(torch.abs(1.0 - tracer._dot(perp, perp)))
        die = torch.where(reflect[:, None], ud - (2.0 * tracer._dot(ud, nrm))[:, None] * nrm,
                          perp + par[:, None] * nrm)

        is_metal, is_diel = mtype == METAL, mtype == DIELECTRIC
        is_light, is_iso = mtype == LIGHT, mtype == ISOTROPIC
        new_d = torch.where(is_diel[:, None], die, torch.where(
            is_metal[:, None], met, torch.where(is_iso[:, None], ruv, lam)))
        att = torch.where(is_diel[:, None], torch.ones_like(albedo), albedo)
        add = (torch.where((~hit)[:, None], thr * background[None], 0.0)
               + torch.where((hit & is_light)[:, None], thr * albedo, 0.0))
        rad.index_add_(0, idx, add)
        live = hit & ((is_metal & metal_ok) | (~is_metal & ~is_light))
        idx, o, d, tm = idx[live], p[live], new_d[live], tm[live]
        thr, pix, smp = (thr * att)[live], pix[live], smp[live]
    return rad, segs, scatters


def render_pixels(sc: FinalScene, cam: tracer.Camera, pixels, spp: int, depth: int, seed: int,
                  batch: int = 1 << 18):
    """Mean radiance ``(P, 3)`` (float32), segments ``(P,)`` and the media's
    scatters (an int) of the ``pixels`` (int64 row-major ids), each over
    samples ``0 .. spp - 1``. No float32 product runs in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pixels = pixels.to(sc.device)
    P = pixels.shape[0]
    rad = torch.zeros((P, 3), dtype=torch.float64, device=sc.device)
    segs = torch.zeros(P, dtype=torch.int64, device=sc.device)
    scatters = 0
    per = max(1, batch // spp)
    with torch.no_grad():
        for k in range(0, P, per):
            pk = pixels[k:k + per]
            pix = pk.repeat_interleave(spp)
            smp = torch.arange(spp, device=sc.device).repeat(pk.shape[0])
            o, d, tm = cam.rays(pix, smp, seed, sc.moving)
            r, s, m = trace(sc, o, d, tm, pix, smp, seed, depth, cam.background)
            rad[k:k + per] = r.double().reshape(-1, spp, 3).sum(dim=1)
            segs[k:k + per] = s.reshape(-1, spp).sum(dim=1)
            scatters += m
    return (rad / spp).float(), segs, scatters
