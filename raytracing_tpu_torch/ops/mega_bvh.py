"""Host-side chunked-BVH build for K5's in-kernel walk, the counterpart of
``raytracing_tpu.ops.mega_bvh.build_chunked_bvh``: the same tree, node
order, skip links and chunk numbering, stored for a GPU thread instead of
the TPU's lane gathers.

The tree: recursive longest-axis median split (stable ``argsort`` on each
primitive's ``bmin`` along the axis) down to homogeneous leaves of at most
``LEAF_SIZE`` primitives of one kind ("chunks"); a span of at most
``LEAF_SIZE`` primitives of both kinds becomes one internal node over a
sphere leaf and a quad leaf. Nodes are numbered in depth-first preorder,
with a skip link each for a stackless walk:

    node i internal:  box hit  -> i + 1 (its first child)
                      box miss -> miss[i]
    node i leaf:      box hit  -> test its chunk's members; then miss[i]

Chunks are renumbered spheres first: sphere chunks are ``[0,
n_sph_chunks)``, quad chunks follow.

Layouts (no lane padding, one record per row):

* ``nodes (K, 8) f32``: ``bmin xyz, bmax xyz, miss, leaf`` (``miss`` -1
  ends the walk; ``leaf`` -1 for an internal node, else the chunk id);
* ``sph_leaf (LS, 8, 8) f32``: per chunk and member ``cx cy cz vx vy vz r
  0`` (center at time 0, velocity, radius);
* ``quad_leaf (LQ, 8, 16) f32``: per chunk and member ``nx ny nz D wx wy
  wz qx qy qz ux uy uz vx vy vz`` (unit normal, plane D, w, corner and
  edges);
* ``sph_gid (LS, 8)`` and ``quad_gid (LQ, 8)`` i32: each member's column
  of the unified table (scene/flatten.py), which the resolve reads.

A chunk with fewer than 8 members is padded with zero records whose gid
is the first member's: a pad sphere has r = 0 and a pad quad a zero
normal, and the intersection tests reject both.

K1's walk (csrc/megakernel_block.cu) reads the same nodes with boxes
padded for its sweep arithmetic (:func:`cull_nodes`), and the ball of ray
origins those pads hold for (:func:`cull_ball`).
"""
from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np

from ..scene import flatten as fl

LEAF_SIZE = 8
# quads thinner than this along an axis are padded to it
# (aabb::pad_to_minimums; raytracing_tpu/ops/bvh.py PAD_DELTA)
PAD_DELTA = 1e-4

# K1's walk pads each primitive's box by SPHERE_PAD of its radius
# (spheres) and COORD_PAD of its largest coordinate magnitude (both kinds),
# which holds for rays that start within SAFE_RADII radii of each sphere
# and QUAD_SAFE_SCALE * (the quad's largest coordinate) + QUAD_SAFE_ABS of
# the origin (see cull_nodes and cull_ball)
SPHERE_PAD = 1.0 / 8.0
COORD_PAD = 2.0 ** -12
SAFE_RADII = 448.0
QUAD_SAFE_SCALE = 128.0
QUAD_SAFE_ABS = 64.0

# nodes columns
N_BMINX, N_BMINY, N_BMINZ, N_BMAXX, N_BMAXY, N_BMAXZ, N_MISS, N_LEAF = range(8)
SPH_LEAF_FIELDS = 8    # cx cy cz vx vy vz r 0
QUAD_LEAF_FIELDS = 16  # nx ny nz D wx wy wz qx qy qz ux uy uz vx vy vz

_SPH_ROWS = [fl.U_G0, fl.U_G1, fl.U_G2, fl.U_G3, fl.U_G4, fl.U_G5, fl.U_G6]
_QUAD_ROWS = [fl.U_G0, fl.U_G1, fl.U_G2, fl.U_G3, fl.U_G4, fl.U_G5, fl.U_G6,
              fl.U_QX, fl.U_QY, fl.U_QZ, fl.U_UX, fl.U_UY, fl.U_UZ,
              fl.U_VX, fl.U_VY, fl.U_VZ]


class ChunkedBVH(NamedTuple):
    nodes: np.ndarray      # (K, 8) f32
    sph_leaf: np.ndarray   # (LS, 8, 8) f32
    sph_gid: np.ndarray    # (LS, 8) i32
    quad_leaf: np.ndarray  # (LQ, 8, 16) f32
    quad_gid: np.ndarray   # (LQ, 8) i32
    depth_max: int         # tree depth (diagnostics)

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_sph_chunks(self) -> int:
        return self.sph_leaf.shape[0]

    @property
    def n_quad_chunks(self) -> int:
        return self.quad_leaf.shape[0]


def _prim_boxes(table, n_sph_pad, n_sph, n_quad, cull=False):
    """Per-primitive AABBs: spheres over their centers at times 0 and 1,
    quads over their four corners, padded where thin. With ``cull``, K1's
    walk's boxes in float64 (:func:`cull_nodes`): every box also padded by
    ``COORD_PAD`` of its largest coordinate magnitude, each sphere by
    ``SPHERE_PAD`` of its radius and each quad by ``PAD_DELTA``."""
    dt = np.float64 if cull else np.float32
    table = np.asarray(table, dt)
    bmin = np.zeros((n_sph + n_quad, 3), dt)
    bmax = np.zeros((n_sph + n_quad, 3), dt)
    r = table[fl.U_G6, :n_sph][:, None]
    if cull:
        r = np.abs(r)
    if n_sph:
        c0 = table[[fl.U_G0, fl.U_G1, fl.U_G2]][:, :n_sph].T
        vel = table[[fl.U_G3, fl.U_G4, fl.U_G5]][:, :n_sph].T
        c1 = c0 + vel
        bmin[:n_sph] = np.minimum(c0 - r, c1 - r)
        bmax[:n_sph] = np.maximum(c0 + r, c1 + r)
    if n_quad:
        qs = slice(n_sph_pad, n_sph_pad + n_quad)
        q = table[[fl.U_QX, fl.U_QY, fl.U_QZ]][:, qs].T
        u = table[[fl.U_UX, fl.U_UY, fl.U_UZ]][:, qs].T
        v = table[[fl.U_VX, fl.U_VY, fl.U_VZ]][:, qs].T
        corners = np.stack([q, q + u, q + v, q + u + v])
        qmin = corners.min(axis=0)
        qmax = corners.max(axis=0)
        thin = (qmax - qmin) < PAD_DELTA
        bmin[n_sph:] = np.where(thin, qmin - PAD_DELTA / 2, qmin)
        bmax[n_sph:] = np.where(thin, qmax + PAD_DELTA / 2, qmax)
    if cull:
        pad = COORD_PAD * np.maximum(np.abs(bmin), np.abs(bmax)).max(axis=1, keepdims=True)
        pad[:n_sph] += SPHERE_PAD * r
        pad[n_sph:] += PAD_DELTA
        bmin, bmax = bmin - pad, bmax + pad
    return bmin, bmax


def _skip_links(leaf: np.ndarray) -> np.ndarray:
    """Miss link of every preorder node: the next node after its subtree
    (-1 past the last)."""
    K = len(leaf)
    size = np.ones(K, np.int64)
    for i in range(K - 1, -1, -1):
        if leaf[i] < 0:
            left = i + 1
            size[i] = 1 + size[left] + size[left + size[left]]
    miss = np.full(K, -1, np.int64)
    stack = [(0, -1)]
    while stack:
        i, m = stack.pop()
        miss[i] = m
        if leaf[i] < 0:
            left = i + 1
            right = left + int(size[left])
            stack.append((left, right))
            stack.append((right, m))
    return miss


def _leaf_table(members_list, table, rows, width):
    """(L, 8, width) member records (the unified-table ``rows``, then
    zeros) and (L, 8) gids for a list of member-column arrays; short
    chunks padded with zero records whose gid is the first member's."""
    L = len(members_list)
    recs = np.zeros((L, LEAF_SIZE, width), np.float32)
    gid = np.zeros((L, LEAF_SIZE), np.int32)
    fields = table[rows]
    for c, members in enumerate(members_list):
        recs[c, :len(members), :len(rows)] = fields[:, members].T
        gid[c] = members[0]
        gid[c, :len(members)] = members
    return recs, gid


def build_chunked_bvh(table: np.ndarray, n_sph_pad: int, n_sph: int, n_quad: int) -> ChunkedBVH:
    """Build from the unified primitive table ``(U_FIELDS, P)``: spheres in
    columns ``[0, n_sph)``, quads in ``[n_sph_pad, n_sph_pad + n_quad)``."""
    table = np.asarray(table, np.float32)
    cols = np.concatenate([np.arange(n_sph), n_sph_pad + np.arange(n_quad)]).astype(np.int64)
    kinds = np.concatenate([np.zeros(n_sph, np.int64), np.ones(n_quad, np.int64)])
    bmin, bmax = _prim_boxes(table, n_sph_pad, n_sph, n_quad)
    if len(cols) == 0:  # no primitives: no nodes, every walk ends at once
        return ChunkedBVH(np.zeros((0, 8), np.float32),
                          np.zeros((0, LEAF_SIZE, SPH_LEAF_FIELDS), np.float32),
                          np.zeros((0, LEAF_SIZE), np.int32),
                          np.zeros((0, LEAF_SIZE, QUAD_LEAF_FIELDS), np.float32),
                          np.zeros((0, LEAF_SIZE), np.int32), 0)

    chunks = []  # (kind, member columns) in emission order
    rows = []    # preorder (bmin, bmax, chunk id or -1)
    depth_max = 0

    def emit(idxs: np.ndarray, depth: int) -> None:
        nonlocal depth_max
        depth_max = max(depth_max, depth)
        node_min = bmin[idxs].min(axis=0)
        node_max = bmax[idxs].max(axis=0)
        homogeneous = bool(np.all(kinds[idxs] == kinds[idxs[0]]))
        if len(idxs) <= LEAF_SIZE and homogeneous:
            rows.append((node_min, node_max, len(chunks)))
            chunks.append((int(kinds[idxs[0]]), cols[idxs]))
            return
        rows.append((node_min, node_max, -1))
        if len(idxs) <= LEAF_SIZE:  # mixed tiny span: one leaf per kind
            left, right = idxs[kinds[idxs] == 0], idxs[kinds[idxs] == 1]
        else:
            axis = int(np.argmax(node_max - node_min))
            s = idxs[np.argsort(bmin[idxs][:, axis], kind="stable")]
            mid = len(idxs) // 2
            left, right = s[:mid], s[mid:]
        emit(left, depth + 1)
        emit(right, depth + 1)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000 + len(cols)))
    try:
        emit(np.arange(len(cols)), 1)
    finally:
        sys.setrecursionlimit(old)

    leaf = np.asarray([r[2] for r in rows], np.int64)
    miss = _skip_links(leaf)
    # chunk ids: spheres first, then quads, each in emission order
    order = sorted(range(len(chunks)), key=lambda c: chunks[c][0])
    remap = np.empty(len(chunks), np.int64)
    remap[order] = np.arange(len(chunks))
    nodes = np.zeros((len(rows), 8), np.float32)
    nodes[:, N_BMINX:N_BMINZ + 1] = np.stack([r[0] for r in rows])
    nodes[:, N_BMAXX:N_BMAXZ + 1] = np.stack([r[1] for r in rows])
    nodes[:, N_MISS] = miss
    nodes[:, N_LEAF] = np.where(leaf >= 0, remap[np.maximum(leaf, 0)], -1)

    ordered = [chunks[c] for c in order]
    sph_leaf, sph_gid = _leaf_table([m for k, m in ordered if k == 0], table, _SPH_ROWS,
                                    SPH_LEAF_FIELDS)
    quad_leaf, quad_gid = _leaf_table([m for k, m in ordered if k == 1], table, _QUAD_ROWS,
                                      QUAD_LEAF_FIELDS)
    return ChunkedBVH(nodes, sph_leaf, sph_gid, quad_leaf, quad_gid, depth_max)


def cull_nodes(bvh: ChunkedBVH, table: np.ndarray, n_sph_pad: int, n_sph: int,
               n_quad: int) -> np.ndarray:
    """``bvh.nodes`` (same order, skip links and chunks) with each box
    refitted to its primitives' padded boxes (``_prim_boxes(cull=True)``)
    and rounded outward to float32: the node table of K1's walk.

    K1 tests a sphere in a·t space, where the discriminant's rounding
    error (up to ~15·2⁻²⁴·a·|oc|², oc = origin - center) lets a ray that
    passes up to 15·2⁻²⁴·|oc|²/(2r) outside the sphere hit it. The pad of
    r/8 covers that band, and the slab test's rounding, for every ray that
    starts within ``SAFE_RADII`` = 448 radii of the center (the band is
    then below r/10, even at 16·2⁻²⁴). COORD_PAD of the box's largest
    coordinate covers the rounding of a quad's hit point and edge tests,
    PAD_DELTA a flat quad, for a ray that starts within
    ``QUAD_SAFE_SCALE`` times the quad's largest coordinate (plus
    ``QUAD_SAFE_ABS``) of the origin. With these boxes the walk never
    culls a box holding a hit the sweep takes, for a ray that starts in
    :func:`cull_ball`; the kernel widens the boxes by a ray's own band for
    the others."""
    nodes = bvh.nodes.copy()
    if len(nodes) == 0:
        return nodes
    lo, hi = _prim_boxes(table, n_sph_pad, n_sph, n_quad, cull=True)
    box_lo = np.zeros((len(nodes), 3))
    box_hi = np.zeros((len(nodes), 3))
    for i in range(len(nodes) - 1, -1, -1):
        leaf = int(nodes[i, N_LEAF])
        if leaf < 0:  # children: i + 1 and the left child's miss link
            kids = [i + 1, int(nodes[i + 1, N_MISS])]
            box_lo[i] = box_lo[kids].min(axis=0)
            box_hi[i] = box_hi[kids].max(axis=0)
            continue
        if leaf < bvh.n_sph_chunks:
            prims = bvh.sph_gid[leaf]
        else:
            prims = n_sph + bvh.quad_gid[leaf - bvh.n_sph_chunks] - n_sph_pad
        box_lo[i] = lo[prims].min(axis=0)
        box_hi[i] = hi[prims].max(axis=0)
    lo32, hi32 = box_lo.astype(np.float32), box_hi.astype(np.float32)
    nodes[:, N_BMINX:N_BMINZ + 1] = np.where(lo32 > box_lo, np.nextafter(lo32, -np.inf), lo32)
    nodes[:, N_BMAXX:N_BMAXZ + 1] = np.where(hi32 < box_hi, np.nextafter(hi32, np.inf), hi32)
    return nodes


def cull_ball(table: np.ndarray, n_sph_pad: int, n_sph: int, n_quad: int):
    """``(cx, cy, cz, r2, band_k)``, float32, for K1's walk over
    :func:`cull_nodes`. A ray that starts inside the ball of center
    ``(cx, cy, cz)`` and squared radius ``r2`` (negative: no ray) meets
    the conditions of those boxes: within ``SAFE_RADII`` radii of every
    sphere's center at both ends of its motion, and within
    ``QUAD_SAFE_SCALE`` times each quad's largest coordinate plus
    ``QUAD_SAFE_ABS`` of the origin. The center is that of the box these
    conditions bound; r2 is shrunk by 2⁻¹⁰ for the kernel's rounding of
    |o - c|². A ray from outside widens each box by its own rounding band,
    ``band_k`` = 16·2⁻²⁵/(smallest radius) times the squared distance to
    the box's farthest point (see csrc/megakernel_block.cu)."""
    t64 = np.asarray(table, np.float64)
    centers, reach = [], []  # constraints |o - center| <= reach
    band_k = 0.0
    if n_sph:
        c0 = t64[[fl.U_G0, fl.U_G1, fl.U_G2], :n_sph].T
        c1 = c0 + t64[[fl.U_G3, fl.U_G4, fl.U_G5], :n_sph].T
        r = np.abs(t64[fl.U_G6, :n_sph])
        centers += [c0, c1]
        reach += [SAFE_RADII * r, SAFE_RADII * r]
        band_k = 2.0 ** -21 / r.min() if r.min() > 0 else np.inf
    if n_quad:
        lo, hi = _prim_boxes(table, n_sph_pad, n_sph, n_quad, cull=True)
        q = np.maximum(np.abs(lo[n_sph:]), np.abs(hi[n_sph:])).max(axis=1)
        centers.append(np.zeros((n_quad, 3)))
        reach.append(QUAD_SAFE_SCALE * q + QUAD_SAFE_ABS)
    if not centers:
        return 0.0, 0.0, 0.0, -1.0, 0.0
    centers, reach = np.concatenate(centers), np.concatenate(reach)
    lo = (centers - reach[:, None]).max(axis=0)
    hi = (centers + reach[:, None]).min(axis=0)
    c = (0.5 * (lo + hi)).astype(np.float32).astype(np.float64)
    rad = float((reach - np.linalg.norm(centers - c, axis=1)).min())
    r2 = np.float32(rad * rad * (1.0 - 2.0 ** -10)) if rad > 0 else -1.0
    return (*(float(x) for x in c), float(r2), float(np.float32(band_k) * np.float32(1 + 2 ** -20)))
