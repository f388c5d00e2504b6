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


def _prim_boxes(table, n_sph_pad, n_sph, n_quad):
    """Per-primitive AABBs: spheres over their centers at times 0 and 1,
    quads over their four corners, padded where thin."""
    bmin = np.zeros((n_sph + n_quad, 3), np.float32)
    bmax = np.zeros((n_sph + n_quad, 3), np.float32)
    if n_sph:
        c0 = table[[fl.U_G0, fl.U_G1, fl.U_G2]][:, :n_sph].T
        vel = table[[fl.U_G3, fl.U_G4, fl.U_G5]][:, :n_sph].T
        r = table[fl.U_G6, :n_sph][:, None]
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
