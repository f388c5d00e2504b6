"""Flatten a compiled :class:`Scene` into the dense per-primitive tables the
block megakernel reads (host-side NumPy): the counterpart of the parts of
``raytracing_tpu.scene.flatten`` that K1 uses, with the same row layouts
and the same values.

* ``sweep_tables``: per-primitive rows for the closest-hit sweep,
  spheres ``(ns_it, 8)`` [c, v, r²] and quads ``(nq_it, 16)``.
* ``unified_table``: one ``(U_FIELDS, P)`` table, spheres in columns
  ``[0, ns_pad)`` and quads after them; its first ``RESOLVE_FIELDS`` rows
  are the resolve table the kernel reads the winner's attributes from.
* ``global_id_map``: kernel primitive index → global scene id.
* ``perlin_tables``: the marble noise's permutations ``(3, 256) i32`` and
  gradients ``(256, 3) f32``.
* ``atlas_texels``: every image's texels row-major, one image after
  another, ``(T, 3) f32``; an image texture's ``A2R`` holds its first
  texel.
* ``media_table``: one row of 8 per participating medium, ``(M, 8) f32``.

Materials and textures are folded into each primitive's row. The TPU
package replicates the resolve, noise and atlas tables eight times for its
(8, 128) gathers and packs large atlases into u8 words behind a texel
cap; a GPU thread reads a plain table, so none of that is here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .types import TEX_CHECKER, TEX_IMAGE, TEX_NOISE, TEX_SOLID, Scene

# sphere table rows
S_CX, S_CY, S_CZ, S_VX, S_VY, S_VZ, S_R = range(7)
S_MTYPE, S_PARAM, S_AR, S_AG, S_AB, S_TKIND, S_TSCALE, S_A2R, S_A2G, S_A2B = range(7, 17)
SPH_FIELDS = 17

# quad table rows: geometry, then the same shading block
Q_QX, Q_QY, Q_QZ, Q_UX, Q_UY, Q_UZ, Q_VX, Q_VY, Q_VZ = range(9)
Q_NX, Q_NY, Q_NZ, Q_D, Q_WX, Q_WY, Q_WZ = range(9, 16)
Q_MTYPE, Q_PARAM, Q_AR, Q_AG, Q_AB, Q_TKIND, Q_TSCALE, Q_A2R, Q_A2G, Q_A2B = range(16, 26)
QUAD_FIELDS = 26

# in-kernel texture kinds
TK_SOLID = 0.0
TK_CHECKER = 1.0
TK_NOISE = 2.0   # marble; TSCALE = noise scale
TK_IMAGE = 3.0   # image; A2R/A2G/A2B = (atlas base texel, width, height)

# Unified primitive table. Geometry rows are kind-specific:
#   spheres: G0..G2 = center, G3..G5 = velocity, G6 = radius
#   quads:   G0..G2 = unit normal, G3 = plane D, G4..G6 = w
# Quad corner q and edges u, v live in rows 17..25 (zero for spheres).
U_G0, U_G1, U_G2, U_G3, U_G4, U_G5, U_G6 = range(7)
U_MTYPE, U_PARAM, U_AR, U_AG, U_AB, U_TKIND, U_TSCALE, U_A2R, U_A2G, U_A2B = range(7, 17)
U_QX, U_QY, U_QZ, U_UX, U_UY, U_UZ, U_VX, U_VY, U_VZ = range(17, 26)
U_FIELDS = 32
# the resolve table is rows [0, RESOLVE_FIELDS) of the unified table
RESOLVE_FIELDS = 17

# media_table rows: the boundary sphere, -1/density and the solid albedo
M_CX, M_CY, M_CZ, M_R2, M_NID, M_AR, M_AG, M_AB = range(8)
MEDIUM_FIELDS = 8

# the atlas base texel is stored in an f32 column, exact below 2^24
MAX_ATLAS_TEXELS = 1 << 24

# sphere sweep rows are padded to a multiple of this (the JAX kernel's
# culling-cluster size; kept so both packages build the same table)
CLUSTER_SIZE = 16


class FlatScene(NamedTuple):
    sphere_table: np.ndarray  # (SPH_FIELDS, max(ns, 1))
    quad_table: np.ndarray    # (QUAD_FIELDS, max(nq, 1))
    supported: bool           # False: the kernel cannot shade this scene


def _np(t):
    return t.detach().cpu().numpy()


def _atlas_bases(sizes: np.ndarray):
    """First texel of each image when the atlas is flattened row-major,
    images one after another."""
    bases, off = [], 0
    for h, w in sizes:
        bases.append(off)
        if h > 0 and w > 0:
            off += int(h) * int(w)
    return bases


def _shading_columns(scene: Scene, mat_id: np.ndarray):
    """Per-primitive folded shading block (10 rows) for ``mat_id`` rows.
    Returns (rows (10, n) f32, supported). A checker folds to
    TK_CHECKER when both children are solid; other nesting is not
    supported. A missing image folds to solid cyan."""
    mats = _np(scene.materials.mtype)
    tex_id = _np(scene.materials.tex_id)
    fuzz = _np(scene.materials.fuzz)
    ior = _np(scene.materials.ior)
    ttype = _np(scene.textures.ttype)
    rgb = _np(scene.textures.rgb)
    scale = _np(scene.textures.scale)
    child = _np(scene.textures.child)
    image_id = _np(scene.textures.image_id)
    sizes = _np(scene.atlas.sizes)
    atlas_bases = _atlas_bases(sizes)

    n = len(mat_id)
    rows = np.zeros((10, n), np.float32)
    supported = True
    for k, m in enumerate(mat_id):
        mt = mats[m]
        t = tex_id[m]
        tk = TK_SOLID
        alb = rgb[t]
        alb2 = np.zeros(3, np.float32)
        tscale = 1.0
        if ttype[t] == TEX_CHECKER:
            even, odd = child[t]
            if ttype[even] == TEX_SOLID and ttype[odd] == TEX_SOLID:
                tk = TK_CHECKER
                alb = rgb[even]
                alb2 = rgb[odd]
                tscale = scale[t]  # already inv_scale (builder.checker)
            else:
                supported = False
        elif ttype[t] == TEX_NOISE:
            tk = TK_NOISE
            tscale = scale[t]
        elif ttype[t] == TEX_IMAGE:
            img = int(image_id[t])
            h, w = int(sizes[img, 0]), int(sizes[img, 1])
            if h <= 0 or w <= 0:
                alb = np.asarray((0.0, 1.0, 1.0), np.float32)  # cyan sentinel
            elif scene.flags.image_bilinear:
                supported = False  # the kernel fetches nearest texels only
            else:
                tk = TK_IMAGE
                alb2 = np.asarray((atlas_bases[img], w, h), np.float32)
        rows[0, k] = mt
        rows[1, k] = fuzz[m] if mt != 2 else ior[m]  # PARAM: fuzz | ior
        rows[2:5, k] = alb
        rows[5, k] = tk
        rows[6, k] = tscale
        rows[7:10, k] = alb2
    return rows, supported


def flatten_scene(scene: Scene) -> FlatScene:
    """Pack the real primitives (radius > 0 spheres, non-degenerate quads)
    into per-kind tables, one column per primitive."""
    center = _np(scene.spheres.center)
    vel = _np(scene.spheres.velocity)
    radius = _np(scene.spheres.radius)
    smat = _np(scene.spheres.mat_id)
    idx = np.nonzero(radius > 0)[0]
    ns = len(idx)
    stab = np.zeros((SPH_FIELDS, max(ns, 1)), np.float32)
    sup_s = True
    if ns:
        stab[S_CX:S_CZ + 1, :ns] = center[idx].T
        stab[S_VX:S_VZ + 1, :ns] = vel[idx].T
        stab[S_R, :ns] = radius[idx]
        stab[S_MTYPE:S_A2B + 1, :ns], sup_s = _shading_columns(scene, smat[idx])

    qq = _np(scene.quads.q)
    qu = _np(scene.quads.u)
    qv = _np(scene.quads.v)
    qmat = _np(scene.quads.mat_id)
    n_cross = np.cross(qu, qv)
    nn = (n_cross * n_cross).sum(-1)
    qidx = np.nonzero(nn > 0)[0]
    mq = len(qidx)
    qtab = np.zeros((QUAD_FIELDS, max(mq, 1)), np.float32)
    sup_q = True
    if mq:
        qtab[Q_QX:Q_QZ + 1, :mq] = qq[qidx].T
        qtab[Q_UX:Q_UZ + 1, :mq] = qu[qidx].T
        qtab[Q_VX:Q_VZ + 1, :mq] = qv[qidx].T
        n_r = n_cross[qidx]
        nn_r = nn[qidx]
        unit_n = n_r / np.sqrt(nn_r)[:, None]
        qtab[Q_NX:Q_NZ + 1, :mq] = unit_n.T
        qtab[Q_D, :mq] = (unit_n * qq[qidx]).sum(-1)
        qtab[Q_WX:Q_WZ + 1, :mq] = (n_r / nn_r[:, None]).T
        qtab[Q_MTYPE:Q_A2B + 1, :mq], sup_q = _shading_columns(scene, qmat[qidx])
    return FlatScene(stab, qtab, bool(sup_s and sup_q))


def _real_counts(flat: FlatScene):
    ns = int(np.count_nonzero(flat.sphere_table[S_R] > 0))
    nxr = flat.quad_table[Q_NX:Q_NZ + 1]
    nq = int(np.count_nonzero((nxr * nxr).sum(0) > 0))
    return ns, nq


def _pad8(n: int) -> int:
    return max(8, -(-max(n, 1) // 8) * 8)


def unified_table(scene: Scene):
    """Build the unified primitive table.

    Returns (table (U_FIELDS, P) f32, ns_pad, nq, supported): spheres in
    columns [0, ns_pad) (padded to a multiple of 8 with radius-0 columns),
    quads in [ns_pad, ns_pad + nq) and zero padding to a multiple of 8."""
    flat = flatten_scene(scene)
    stab, qtab = flat.sphere_table, flat.quad_table
    ns, nq = _real_counts(flat)
    ns_pad = _pad8(ns)
    table = np.zeros((U_FIELDS, ns_pad + _pad8(nq)), np.float32)
    if ns:
        table[U_G0:U_G2 + 1, :ns] = stab[S_CX:S_CZ + 1, :ns]
        table[U_G3:U_G5 + 1, :ns] = stab[S_VX:S_VZ + 1, :ns]
        table[U_G6, :ns] = stab[S_R, :ns]
        table[U_MTYPE:U_A2B + 1, :ns] = stab[S_MTYPE:S_A2B + 1, :ns]
    if nq:
        o = ns_pad
        table[U_G0:U_G2 + 1, o:o + nq] = qtab[Q_NX:Q_NZ + 1, :nq]
        table[U_G3, o:o + nq] = qtab[Q_D, :nq]
        table[U_G4:U_G6 + 1, o:o + nq] = qtab[Q_WX:Q_WZ + 1, :nq]
        table[U_MTYPE:U_A2B + 1, o:o + nq] = qtab[Q_MTYPE:Q_A2B + 1, :nq]
        table[U_QX:U_QZ + 1, o:o + nq] = qtab[Q_QX:Q_QZ + 1, :nq]
        table[U_UX:U_UZ + 1, o:o + nq] = qtab[Q_UX:Q_UZ + 1, :nq]
        table[U_VX:U_VZ + 1, o:o + nq] = qtab[Q_VX:Q_VZ + 1, :nq]
    return table, ns_pad, nq, flat.supported


def sweep_tables(scene: Scene):
    """Per-primitive rows for the kernel's closest-hit sweep.

    Returns (sph (ns_it, 8) f32, quad (nq_it, 16) f32, ns, nq, ns_pad).
    Sphere columns: cx cy cz vx vy vz r² 0, with r² computed in f32; pad
    rows carry r² = -1e30, so their discriminant is always negative.
    Quad columns: nx ny nz D qx qy qz wx wy wz ux uy uz vx vy vz; pad rows
    have a zero normal and are rejected as parallel. Winner index
    ``ns_pad + j`` is quad ``j`` in the unified table."""
    flat = flatten_scene(scene)
    stab, qtab = flat.sphere_table, flat.quad_table
    ns, nq = _real_counts(flat)
    ns_pad = _pad8(ns)
    ns_it = max(CLUSTER_SIZE, -(-max(ns, 1) // CLUSTER_SIZE) * CLUSTER_SIZE)
    nq_it = _pad8(nq)
    sph = np.zeros((ns_it, 8), np.float32)
    sph[:, 6] = -1e30
    if ns:
        sph[:ns, 0:3] = stab[S_CX:S_CZ + 1, :ns].T
        sph[:ns, 3:6] = stab[S_VX:S_VZ + 1, :ns].T
        r = stab[S_R, :ns].astype(np.float32)
        sph[:ns, 6] = r * r
    quad = np.zeros((nq_it, 16), np.float32)
    if nq:
        quad[:nq, 0:3] = qtab[Q_NX:Q_NZ + 1, :nq].T
        quad[:nq, 3] = qtab[Q_D, :nq]
        quad[:nq, 4:7] = qtab[Q_QX:Q_QZ + 1, :nq].T
        quad[:nq, 7:10] = qtab[Q_WX:Q_WZ + 1, :nq].T
        quad[:nq, 10:13] = qtab[Q_UX:Q_UZ + 1, :nq].T
        quad[:nq, 13:16] = qtab[Q_VX:Q_VZ + 1, :nq].T
    return sph, quad, ns, nq, ns_pad


def global_id_map(scene: Scene):
    """Kernel primitive index → global scene id. Kernel sphere ``j`` is the
    j-th real sphere; kernel quad ``j`` (column ``ns_pad + j``) is the j-th
    real quad, with global id ``n_spheres + quad index``. Padding columns
    map to -1."""
    radius = _np(scene.spheres.radius)
    sidx = np.nonzero(radius > 0)[0]
    n_cross = np.cross(_np(scene.quads.u), _np(scene.quads.v))
    qidx = np.nonzero((n_cross * n_cross).sum(-1) > 0)[0]
    ns, nq = len(sidx), len(qidx)
    ns_pad = _pad8(ns)
    out = np.full(ns_pad + max(nq, 1), -1, np.int32)
    out[:ns] = sidx
    out[ns_pad:ns_pad + nq] = scene.n_spheres + qidx
    return out


def perlin_tables(scene: Scene):
    """The marble noise's tables as the kernels read them: ``perm (3, 256)
    i32`` (rows perm_x, perm_y, perm_z) and ``vec (256, 3) f32`` (the
    gradient vectors)."""
    pt = scene.perlin
    perm = np.stack([_np(pt.perm_x), _np(pt.perm_y), _np(pt.perm_z)]).astype(np.int32)
    return perm, _np(pt.randvec).astype(np.float32)


def atlas_texels(scene: Scene) -> np.ndarray:
    """Every image's texels, row-major, images one after another at the
    bases ``_shading_columns`` folds into ``A2R``: ``(T, 3) f32`` (one
    zero row when the scene has no image). Raises ValueError from
    ``MAX_ATLAS_TEXELS`` texels on, whose bases an f32 column cannot hold."""
    sizes = _np(scene.atlas.sizes)
    texels = _np(scene.atlas.texels)
    parts = [texels[k, :h, :w].reshape(h * w, 3) for k, (h, w) in enumerate(sizes)
             if h > 0 and w > 0]
    total = sum(len(p) for p in parts)
    if total >= MAX_ATLAS_TEXELS:
        raise ValueError(f"image atlas of {total} texels: the kernels address at most "
                         f"{MAX_ATLAS_TEXELS - 1} (the base texel is an f32 table entry)")
    if not parts:
        return np.zeros((1, 3), np.float32)
    return np.ascontiguousarray(np.concatenate(parts).astype(np.float32))


def media_table(scene: Scene) -> np.ndarray:
    """The scene's media as K1 reads them: ``(M, MEDIUM_FIELDS) f32``
    rows ``cx cy cz r² -1/density ar ag ab`` (r² and -1/density computed
    in f32; a density of 0 gives -inf, a free path that never ends),
    ``(0, MEDIUM_FIELDS)`` without media."""
    out = np.zeros((scene.n_media, MEDIUM_FIELDS), np.float32)
    if scene.n_media:
        m = scene.media
        r = _np(m.radius).astype(np.float32)
        out[:, M_CX:M_CZ + 1] = _np(m.center)
        out[:, M_R2] = r * r
        with np.errstate(divide="ignore"):
            out[:, M_NID] = np.float32(-1.0) / _np(m.density).astype(np.float32)
        tex = _np(scene.materials.tex_id)[_np(m.mat_id)]
        out[:, M_AR:M_AB + 1] = _np(scene.textures.rgb)[tex]
    return out
