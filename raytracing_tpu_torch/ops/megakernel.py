"""The megakernel forward trace: scene tables for K1 and K5 and the phased
trace that drives them, the counterpart of ``raytracing_tpu.ops.megakernel``
(``MegaScene``, ``build_mega_scene``, ``trace_megakernel``).

Two layouts trace a phase. The block layout is K1 (ops/megakernel_block.py),
whose closest hit is a sweep over every primitive or, from
``CULL_MIN_PRIMS`` primitives, a walk of the chunked BVH with the sweep's
arithmetic and result. The group layout is K5 (ops/megakernel_group.py),
whose closest hit is a walk of the same BVH in its own arithmetic or a
dense sweep of the unified table. By default a scene of more than
``BVH_MIN_CHUNKS`` chunks of 8 primitives walks the BVH in the group
layout, and every other scene takes the block layout. A scene with
participating media always takes the block layout: only K1 traces them
(its MEDIUM instantiations), and K5 refuses them.

A trace runs its phases in turn, each one kernel launch of
``phase_depths[k]`` bounces. Between phases the rays are compacted
alive-first with a stable sort, so later phases trace the survivors at
full occupancy; the phase
offset feeds the RNG bounce counter, so every phase schedule traces the
same paths and counts the same segments. Static ``phase_prefixes`` limit
a later phase to its first P rays; the trailing ``ok`` flag says whether
every live ray was inside its prefix.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..scene import flatten as fl
from ..scene.types import Scene
from ..utils.profiling import stage
from . import mega_bvh
from . import megakernel_block as mb
from . import megakernel_group as mg
from .megakernel_block import pack_rays

BLOCK = 1024  # launches are multiples of this many rays
CHUNK = mega_bvh.LEAF_SIZE  # primitives per chunk
# the BVH walk is chosen once a scene has more than this many chunks
# (raytracing_tpu/ops/megakernel.py BVH_MIN_CHUNKS)
BVH_MIN_CHUNKS = 256
# unified-table rows K5 reads: the resolve rows, then the quads' corner
# and edges (U_QX..U_VZ)
GROUP_FIELDS = fl.U_VZ + 1


@dataclass
class MegaScene:
    """The tables K1 and K5 read, on one device."""
    sph_sweep: torch.Tensor   # (ns_it, 8) f32: cx cy cz vx vy vz r² 0
    quad_sweep: torch.Tensor  # (nq_it, 16) f32
    table: torch.Tensor       # (GROUP_FIELDS, P) f32: unified-table rows
    kid_map: torch.Tensor     # (P,) i32: kernel primitive → global scene id, -1 padding
    nodes: torch.Tensor       # (K, 8) f32 BVH nodes (ops/mega_bvh.py)
    cull_nodes: torch.Tensor  # (K, 8) f32 the same nodes with K1's padded boxes
    cull_ball: tuple          # K1's walk: (cx, cy, cz, r2, band_k), mega_bvh.cull_ball
    sph_leaf: torch.Tensor    # (LS, 8, 8) f32 sphere chunk members
    sph_gid: torch.Tensor     # (LS, 8) i32 their unified columns
    quad_leaf: torch.Tensor   # (LQ, 8, 16) f32 quad chunk members
    quad_gid: torch.Tensor    # (LQ, 8) i32
    perm: torch.Tensor        # (3, 256) i32 marble noise permutations (zeros without noise)
    grad: torch.Tensor        # (256, 3) f32 marble noise gradients (zeros without noise)
    atlas: torch.Tensor       # (T, 3) f32 image texels (one zero row without images)
    n_sph: int                # real spheres
    n_quad: int               # real quads
    n_sph_pad: int            # first quad column of ``table``
    moving: bool              # any sphere with nonzero velocity
    has_noise: bool           # any primitive with a noise texture
    has_image: bool           # any primitive with an image texture
    media: torch.Tensor       # (M, 8) f32 media (scene/flatten.py media_table; one zero row without)
    n_media: int              # participating media, tested by K1 against every ray

    @property
    def resolve(self) -> torch.Tensor:
        """(RESOLVE_FIELDS, P): the rows the winner's fields are read from."""
        return self.table[:fl.RESOLVE_FIELDS]

    @property
    def n_prims(self) -> int:
        return self.table.shape[1]

    @property
    def n_sph_chunks(self) -> int:
        return self.sph_leaf.shape[0]

    @property
    def n_quad_chunks(self) -> int:
        return self.quad_leaf.shape[0]


def expressible(scene: Scene) -> bool:
    """Whether K1's and K5's tables can express ``scene``: False for a
    checker of non-solid textures or bilinear image filtering."""
    return fl.flatten_scene(scene).supported


def build_mega_scene(scene: Scene, device=None) -> MegaScene:
    """Flatten ``scene`` into K1's and K5's tables on ``device`` (default:
    the scene's own device)."""
    if device is None:
        device = scene.spheres.radius.device
    table, ns_pad, _, supported = fl.unified_table(scene)
    if not supported:
        raise ValueError("scene is not expressible in the megakernel's tables (checker of "
                         "non-solid textures, or bilinear image filtering); use "
                         "hit_method='brute' or 'auto'")
    sph, quad, n_sph, n_quad, _ = fl.sweep_tables(scene)
    tkind = table[fl.U_TKIND]
    kid = np.full(table.shape[1], -1, np.int32)
    gid = fl.global_id_map(scene)
    kid[:len(gid)] = gid
    # the BVH over the unified table's own column order (the JAX package
    # reorders spheres in Morton order first, for a cluster cull the port
    # does not have)
    bvh = mega_bvh.build_chunked_bvh(table, ns_pad, n_sph, n_quad)
    has_noise = bool(np.any(tkind == fl.TK_NOISE))
    has_image = bool(np.any(tkind == fl.TK_IMAGE))
    if has_noise:
        perm, grad = fl.perlin_tables(scene)
    else:
        perm, grad = np.zeros((3, 256), np.int32), np.zeros((256, 3), np.float32)
    atlas = fl.atlas_texels(scene) if has_image else np.zeros((1, 3), np.float32)
    media = fl.media_table(scene)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return MegaScene(
        sph_sweep=t(sph), quad_sweep=t(quad), table=t(table[:GROUP_FIELDS]),
        kid_map=t(kid), nodes=t(bvh.nodes),
        cull_nodes=t(mega_bvh.cull_nodes(bvh, table, ns_pad, n_sph, n_quad)),
        cull_ball=mega_bvh.cull_ball(table, ns_pad, n_sph, n_quad),
        sph_leaf=t(bvh.sph_leaf), sph_gid=t(bvh.sph_gid), quad_leaf=t(bvh.quad_leaf),
        quad_gid=t(bvh.quad_gid),
        perm=t(perm), grad=t(grad), atlas=t(atlas),
        n_sph=n_sph, n_quad=n_quad, n_sph_pad=ns_pad,
        moving=bool(np.any(sph[:, 3:6] != 0.0)), has_noise=has_noise, has_image=has_image,
        media=t(media if len(media) else np.zeros((1, fl.MEDIUM_FIELDS), np.float32)),
        n_media=len(media),
    )


def select_layout(mega: MegaScene, layout=None, use_bvh=None):
    """``(layout, use_bvh)`` of a trace, as the JAX ``trace_megakernel``
    selects them: ``use_bvh=None`` walks the BVH iff the scene has more
    than ``BVH_MIN_CHUNKS`` chunks, and ``layout=None`` is the group layout
    iff the walk is chosen. The block layout has no walk (K5's; K1 has a
    walk of its own, ``cull``). A scene with media takes the block layout:
    ``layout=None`` picks it, and the group layout raises."""
    if mega.n_media:
        if layout == "group" or use_bvh:
            raise ValueError(f"the group layout (K5) does not trace participating media, and "
                             f"this scene has {mega.n_media}: trace it with layout='block' (K1)")
        return "block", False
    resolved = use_bvh if use_bvh is not None else mega.n_prims // CHUNK > BVH_MIN_CHUNKS
    if layout is None:
        layout = "group" if resolved else "block"
    if layout not in ("block", "group"):
        raise ValueError(f"layout must be 'block', 'group' or None, got {layout!r}")
    if layout == "block":
        if use_bvh:
            raise ValueError("the block layout (K1) has no BVH walk; use layout='group'")
        resolved = False
    return layout, bool(resolved)


def trace_megakernel(mega: MegaScene, o, d, time, pixel_ids: torch.Tensor,
                     sample_ids: torch.Tensor, background, max_depth: int, seed: int,
                     phase_depths=None, active0=None, want_counts: bool = False,
                     phase_prefixes=None, want_ids=False, layout=None, use_bvh=None,
                     plain: bool = False, cull=None, camera=None):
    """Trace B rays (a multiple of BLOCK) through K1 or K5.

    ``camera`` (a ``render.camera.CameraStart``) takes the place of ``o``,
    ``d`` and ``time``, which must then be None: the rays are the camera
    rays of ``(pixel_ids, sample_ids)`` at ``seed``, and in the block
    layout K1's first phase computes them itself
    (``megakernel_block.trace_block(camera=...)``), so no ray tensor is
    made; the group layout (K5) takes its rays from ``camera.rays``, and
    K1's plain version packs them itself. ``active0`` (a bool tensor) says
    which rays start alive either way. The results are those of the
    same trace fed ``camera.rays``, bit for bit.

    ``layout`` is ``"block"`` (K1), ``"group"`` (K5) or None, and
    ``use_bvh`` a bool or None: see :func:`select_layout`. The group layout
    takes none of ``want_ids``, ``want_counts``, ``phase_prefixes`` and
    ``cull`` (K1's search, ``mb.trace_block``; the plain version has one).

    Returns ``(radiance (B, 3), segments)`` in camera order, ``segments``
    an int64 0-d tensor on the rays' device, then the extras in this
    order:

    * ``want_ids=True``: ``ids (sum(phases), B) i32``, the global winner
      id per (bounce, ray) in camera order, -1 on a miss and after the
      ray died (a prefix-cut tail records -1);
    * ``want_ids="compacted"``: ``ids0 (pd0, B)`` (the first phase, in
      camera order), ``later (W, B)`` (the later phases' rows, W =
      sum(phases[1:]), in the final compacted lane order) and ``perm
      (B,)`` (the camera index of each compacted lane), for
      ``replay_grads_sorted(compacted=...)``, which moves ``later``
      straight to its length order. The JAX package packs three 10-bit
      ids per int32 word for its sorts; here a ``(pd, B)`` block moves
      through a compaction with one ``[:, order]`` gather, so the rows are
      unpacked and the bundle has no ``pack``;
    * ``want_counts``: ``counts (B,) i32`` (per-ray bounces, camera
      order), and with ``want_ids="compacted"`` also ``counts_c`` in the
      compacted order;
    * ``phase_prefixes``: the ``ok`` flag (0-d bool tensor), False when a
      phase had a live ray past its prefix. ``phase_prefixes`` holds one
      entry per phase: None, or a BLOCK multiple up to B; the first must
      be None.

    ``plain=True`` runs the kernels' plain PyTorch versions on any device.

    Stages (``utils.profiling``): ``camera`` (the packed rays or, with
    ``camera``, the ids, and the trace's start state), then per phase
    ``k1`` (the launch alone) and ``compact`` (its segments, counts and
    ids, and before a later phase the alive-first sort, its gathers and
    that phase's prefix check and inputs), then ``accumulate`` (the
    radiance in camera order) and, with ids or counts, ``compact`` (their
    camera-order outputs)."""
    if (camera is None) == (o is None):
        raise ValueError("pass the rays (o, d, time) or a camera start (camera=), not both")
    B = pixel_ids.shape[0]
    if B % BLOCK:
        raise ValueError(f"megakernel batch must be a multiple of {BLOCK}, got {B}")
    if want_ids not in (False, True, "compacted"):
        raise ValueError(f"want_ids must be False, True or 'compacted', got {want_ids!r}")
    layout, use_bvh = select_layout(mega, layout, use_bvh)
    if layout == "group":
        for name, v in (("want_ids", want_ids), ("want_counts", want_counts),
                        ("phase_prefixes", phase_prefixes), ("cull", cull)):
            if v not in (None, False):
                raise ValueError(f"{name} requires the block layout (K1); this trace "
                                 f"runs the group layout (K5)")
        phase_fn = mg.trace_group_torch if plain else mg.trace_group
    else:
        phase_fn = mb.trace_block_torch if plain else mb.trace_block
    dev = pixel_ids.device
    phases = list(phase_depths) if phase_depths is not None else [max_depth]
    if phase_prefixes is not None:
        if len(phase_prefixes) != len(phases) or phase_prefixes[0] is not None:
            raise ValueError("phase_prefixes: one entry per phase, the first None")
        for p in phase_prefixes[1:]:
            if p is not None and not (0 < p <= B and p % BLOCK == 0):
                raise ValueError(f"prefix must be a {BLOCK}-multiple in (0, {B}], got {p}")

    if layout == "group":
        kw = dict(use_bvh=use_bvh)
    else:
        kw = dict(want_ids=bool(want_ids)) if plain else dict(want_ids=bool(want_ids), cull=cull)
    start = {}  # the first phase's camera start (K1 computes its rays)
    with stage("camera", dev):
        if camera is not None and layout == "group":
            o, d, time = camera.rays(pixel_ids, sample_ids, seed)
        if camera is None or layout == "group":
            ray_f, ray_i = pack_rays(o, d, time, pixel_ids, sample_ids, active0)
        else:
            ray_f, ray_i = None, torch.stack([pixel_ids, sample_ids]).to(torch.int32)
            start = dict(camera=camera, alive=active0)
        perm = torch.arange(B, device=dev)  # camera index of each current lane
        counts = torch.zeros(B, dtype=torch.int32, device=dev) if want_counts else None
        segments = torch.zeros((), dtype=torch.int64, device=dev)
        ok = torch.ones((), dtype=torch.bool, device=dev)
    ids_cam = []    # (pd, B) id blocks in camera order
    ids_later = []  # "compacted": later phases' blocks, kept in the current lane order

    offset = 0
    n, ray_f_n, ray_i_n = B, ray_f, ray_i  # the first phase traces every lane
    for pi, pd in enumerate(phases):
        last = pi == len(phases) - 1
        with stage("k1", dev):
            rad, bc, state, *ids = phase_fn(
                mega, ray_f_n, ray_i_n, seed, offset,
                max_depth=pd, background=background, want_state=not last,
                **kw, **(start if pi == 0 else {}))
        with stage("compact", dev):
            segments = segments + bc.sum()
            if counts is not None:
                counts[:n] += bc
            if want_ids:
                blk = torch.full((pd, B), -1, dtype=torch.int32, device=dev)
                blk[:, :n] = ids[0]
                if pi == 0:
                    ids_cam.append(blk)  # the first phase runs in camera order
                elif want_ids == "compacted":
                    ids_later.append(blk)
                else:
                    cam = torch.empty_like(blk)
                    cam[:, perm] = blk
                    ids_cam.append(cam)
            if last:
                if ray_f is None:  # a camera start traced in one phase
                    rad_lanes = rad
                else:
                    ray_f[mb.RR:mb.RB + 1, :n] = rad
                    rad_lanes = ray_f[mb.RR:mb.RB + 1]
                break
            if ray_f is None:  # the first phase traced every lane
                ray_f = state
            else:
                ray_f[:, :n] = state
            offset += pd
            # alive-first stable compaction
            order = torch.argsort((ray_f[mb.ACT] <= 0.0).to(torch.uint8), stable=True)
            ray_f = ray_f[:, order]
            ray_i = ray_i[:, order]
            perm = perm[order]
            if counts is not None:
                counts = counts[order]
            ids_later = [x[:, order] for x in ids_later]
            n = B
            if phase_prefixes is not None and phase_prefixes[pi + 1] is not None:
                n = phase_prefixes[pi + 1]
                # exact iff every ray past the prefix is already dead
                ok = ok & ~torch.any(ray_f[mb.ACT, n:] > 0.0)
            ray_f_n, ray_i_n = ray_f[:, :n].contiguous(), ray_i[:, :n].contiguous()

    with stage("accumulate", dev):
        radiance = torch.empty((B, 3), dtype=torch.float32, device=dev)
        radiance[perm] = rad_lanes.T
    out = [radiance, segments]
    with stage("compact", dev) if want_ids or counts is not None else contextlib.nullcontext():
        if want_ids == "compacted":
            later = (torch.cat(ids_later) if ids_later
                     else torch.zeros((0, B), dtype=torch.int32, device=dev))
            out += [ids_cam[0], later, perm]
        elif want_ids:
            out.append(torch.cat(ids_cam))
        if counts is not None:
            cam_counts = torch.empty_like(counts)
            cam_counts[perm] = counts
            out.append(cam_counts)
            if want_ids == "compacted":
                out.append(counts)
    if phase_prefixes is not None:
        out.append(ok)
    return tuple(out)
