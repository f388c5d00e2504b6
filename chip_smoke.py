#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (raytracing_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phase 1 builds the CUDA kernels from raytracing_tpu_torch/csrc with nvcc.
Phase 2 holds K1 against its plain PyTorch version on the card
(three_spheres, cornell_box, bouncing_spheres), recorded ids included.
Phase 3 renders the bench workload (bouncing_spheres 400x225, 100 spp,
depth 20, seed 7) through Renderer with the [2,2,3,4,9] schedule and
planned prefixes, counts the kernels' launches in that render and checks
the segment count; it also holds a small render on the card against the
same render on the CPU. Phase 4 times K1 and its plain version on one
full-width launch. Phase 5 holds K3 and K2 (the decision replay) against
their plain versions on small scenes and on one full-width depth-20
chunk of the fwd+bwd workload (B = 360,448), and times them; K3's probe
times its design before the refill (one thread per ray) against K3's in
turns and counts the share of a warp's lanes busy at a bounce; the chunk's
table reduction runs through the fold kernel (one launch), against a
float64 sum, with index_add_ per bounce and the one-hot matmul timed
beside it. Phase 6 runs the fwd+bwd bench
(raytracing_tpu_torch.bench: the steps of bench_fwd_bwd) and counts the
kernels' launches in one of its sweeps (the fold once a chunk).
Phase 7 drives replay_trace_kernel (K3 forward, K2 backward by
autograd) on that chunk and counts its launches.
Phase 8 holds K5 (the group megakernel, BVH walk and dense sweep) against
its plain version, bit for bit, on small scenes, and the walk against the
sweep. Phase 9 runs one full-width depth-20 launch (B = 180,224) of
bouncing_spheres_64 (the bench scene on a 64x64 grid, ~4,100 spheres) and
of bouncing_spheres forced through the walk: K5 against its plain version,
bit for bit, and against K1 on the same rays, with times and K5's bound
from the plain version's visit counts; then K5's probe on the same
launch: the walk in the baseline design (before the guarded root and
the node/leaf split) against K5's in turns, both bit-equal to the plain
version, and the counting instantiation of each (the share of a warp's
lanes active at a box and at a member test; K5's counts must be the
plain version's). It also holds sqrt_rn on the card against the float64
route, forward and backward, on 2^24 random float32 inputs and the edge
values. Phase
10 renders bouncing_spheres_64 (400x225, 100 spp, depth 20) through
Renderer, which picks K5 on its own, and counts the kernels' launches.
Phase 11 holds K4 (the table gather) against its plain version, bit for
bit, on one bounce's K1-recorded ids of a fwd+bwd chunk (B = 360,448,
L = 512) and on the bouncing_spheres_64 replay table (L = 4,224), and the
fold (its backward) against a float64 sum, and times them, index_select,
index_add_ and the one-hot matmul. Phase 12 runs the
differentiable-rendering path at full width: K1 decisions, then
replay_trace_fast (one K4 lookup per bounce) under autograd with an MSE
and its backward to sphere centers, texture rgb and the camera's
lookfrom, chunk by chunk; the first chunk against replay_trace_kernel
(K3/K2), then one timed 25-chunk sweep with its K4 and fold launches
counted (one fold per lookup's backward).
Phase 13 runs render_once (the wavefront integrator) once with its
backward at 400x225, spp 1, depth 20, against trace_megakernel's segment
count on the same rays, and camera_grad through render_once against the
one through render_replay on perlin_sphere. Phase 14 fits the albedos of
single_sphere with fit_albedo.
Phase 15 holds K1's marble and image shading against its plain version
(perlin_sphere, simple_light, earth; recorded ids), phase 16 K5 on the
same launches against its plain version and against K1, phase 17 K1's
depth cap (per-ray depths, the pool's launches) against its plain
version. Phase 18 times one full-width launch (B = 180,224) of
perlin_sphere and of earth at depth 50 in K1 and K5, with bounds that
count the marble and image work. Phase 19 renders the bench workload
through Renderer(schedule="pool"): the segments of phase 3's phased
render exactly, its image within one u8 level, both schedules timed in
turns, K1's launches counted. Phase 20 renders perlin_sphere,
simple_light and earth at their registry configurations through both
schedules (equal segments), and small renders on the card against the
CPU. Phase 21 runs render_replay_fast (K1 decisions) on perlin_sphere
against render_replay, image and camera gradient.
K1 has two searches with one result: the sweep over every row and the
walk of the chunked BVH (trace_block's ``cull``). Phases 2, 4, 15, 17
and 18 run both, hold each bit for bit against the plain version (rad,
bounces, state, ids) and print both times; phase 9 holds the walk
against the sweep on bouncing_spheres_64. Phase 22 times both on one
full-width launch of every registry scene and of bench-like grids of 8 to
257 primitives (the walk's threshold, CULL_MIN_PRIMS), holds both against
the plain version on a pool-shaped launch of bouncing_spheres_64 with the
depth cap, renders that scene through the pool schedule with each search
(K1 walks, K5 is not used), and runs the walk on a scene too large for
the sweep's shared memory.
Phase 23 renders a scene the megakernels cannot express (bilinear image
filtering) through Renderer(hit_method="auto"), which takes the
integrator, against the same render on the CPU; then such a scene of 82
spheres (tests/torch_parity.py bilinear_grid), which "auto" sends through
the integrator's BVH, fused: the walk kernel launched once a bounce of
every launch, against the CPU.
Phase 24 runs the CLI (``cli.main(["render", ...])``) at the bench
configuration with --auto-prefix: its PPM byte-equal to write_ppm of a
Renderer render with the same settings, its log's segments exactly the
port's bench count, K1 the only kernel launched, as often as phase 3's
plan and render together. Phase 25 renders the bench workload with a
checkpoint written after every sample chunk and without, in turns, then
resumes the middle checkpoint in a new Renderer: radiance and segments
bit-equal to the whole render. Phase 26 runs the integrator's BVH
(ops/traverse.py; tools/time_bvh_walk.py): the walk kernel rt_bvh_walk
(csrc/bvh_walk.cu) against the plain lockstep walk, winner and t bit for
bit, on bouncing_spheres' camera launch at 400x225, 4 spp (B = 180,224)
and on the rays leaving its first bounce, timed with the plain walk and
the brute-force hit beside it and its bound from the plain walk's visit
counts; closest_hit_bvh against closest_hit_brute on the same rays
(validity equal, ties at most B/1000, t bit-equal where the primitive is
the same); that configuration at depth 8 rendered through "bvh" fused
(after its capture under torch.cuda.set_sync_debug_mode("error") until
its copy to the host), "bvh" looped and "brute" fused, in turns, fused
bit-equal to looped, with one walk launch a bounce of every launch;
render_once and scene_grad through closest_hit_bvh against brute force
(image bit-equal, gradients as the CPU test holds them); and the bench
configuration (400x225, 100 spp, depth 20) through "bvh" fused, within
mean |diff| 2e-3 and the segment bar of phase 24's megakernel render,
with its walls, walk launches and, from one render under torch.profiler,
the device's busy share. Phase 27 times entry()'s forward (render_once)
on the card.
Phase 28 runs the BASELINE acceptance configurations 1-5 at full size
through raytracing_tpu_torch.acceptance (one render each, the default
Renderer) and holds each against ACCEPTANCE_r05.json's workload count
(segments within max(4, s/200); config 3 exactly the port's bench count)
and image statistics (mean u8 within 1.0, held for every config but
earth's, whose texture is the repository's procedural stand-in;
non-black fraction within 0.01); then K3, K2 and the fold at depth 50
against their plain versions (K3 and K2 bit for bit, the fold within
phase 11's bar of its float64 sum) on a 400x225 chunk and on
cornell_box, and K2 and the fold at config 5's chunk size (3,244,032
rays: K2's output passes 2^31 elements; K2 held bit for bit on the tiles
of the rays past 32 bounces, a middle tile and the last); then config 5's
fwd+bwd (1200x675, 500 spp, depth 50): the planning sweep and one
planned sweep, whose
decision pass must count exactly the forward render's segments, with
finite gradients, a non-zero rgb gradient and its peak device memory.
Phase 29 renders the four C++ comparison configurations through the
default Renderer against the statistics CPP_COMPARE.json stores, under
its tolerances. Phase 30 runs the sharded renders (raytracing_tpu_torch.
parallel): two ranks on this card over gloo (dp2 and sp2 megakernel at
the bench configuration, phases [2, 3, 15]: dp2 bit-equal to phase 25's
single-process image (phase 3's schedule traces the same radiance bit
for bit) and its u8 image to phase 3's, sp2 within 1e-5, both with the
bench's segments; dp1 x tp2 brute force at 100 px, 4 spp, depth 8
within 1e-5 of the single-process brute render; at that size dp2 through
the BVH, every rank walking the whole BVH with the walk kernel, within
1e-5 of the single-process BVH render, and dp1 x tp2 through the BVH,
each rank walking its range's own BVH, with fewer than 0.2% of pixels
off it by more than 1e-4, as tests/test_torch_parallel.py holds it),
K1 and the walk counted on every rank, and one rank over NCCL (dp1
megakernel, bit-equal).
Phase 31 runs replays past 64 bounces: K3 and K2 bit for bit against
their plain versions at depth 96 on the deep scene (tests/torch_parity.py
deep_scene: the camera inside a fuzz-0 metal sphere) and on cornell_box,
the rays past 64 bounces held apart, with the fold of the 96 bounces in
two launches (windows of 64 bounces), over every ray and over the planned
prefixes, within phase 11's bar of its float64 sum, taken per row (2e-6
per ray-bounce that row takes); on the deep scene the first window alone
must fail that bar. K2 on the bench chunk traced at depths 20, 50 and
100, bit-equal to its plain version and timed, with the fold over the
planned prefixes (one launch per window) at the same bar, which the
first window alone must fail at depth 100;
replay_trace_kernel forward and backward at depth 100; and the fwd+bwd
bench sweep at depth 100 (phases [2, 2, 3, 4, 89]) beside the same sweep
at depth 20, in which the kernels' launches are counted (the fold twice a
chunk at depth 100): its segments equal to a forward render's at depth
100, finite gradients, its wall and peak device memory; and its first
chunk again through the sweep's own path, K2 bit-equal to its plain
version on the inputs the sweep gave it, the fold over the sweep's
planned prefixes within phase 11's bar per row and phase 5's relative-L2
bar of the float64 sum, with the chunk's scene gradients from the fold,
from the plain version's float32 index_add_ and from the first window
alone, each against those from the float64 sum.
Phase 32 holds the fused single dispatch (Renderer(fused=True), the
default, and the bench's fused plan and sweep: one launch or
chunk captured once as a CUDA graph and replayed once a launch) against
the launch loop (fused=False), timed in turns (tools/time_fused.py): the
bench render's plan (equal prefixes), the bench render (u8 and f32
bit-equal, 24,259,990 segments, ok, 250 K1 launches either way),
bouncing_spheres_64 (K5, bit-equal), the bench's fwd+bwd sweep (loss,
segments and ok equal; the gradients of both against a sweep with a
float64 fold, per row at phase 11's bar for the ray-bounces each row
gathers and in whole at phase 5's relative-L2 bar) and BASELINE config
5's render (bit-equal, phase 28's segments) and sweep (phase 28's planned
setup, which ran its chunk loop), with walls, capture seconds and peak
device memory. Phases 3, 6, 10 and 31 time the fused path (their counts
read after the render or sweep that captured); phases 25 and 28 keep the
loop where they measure it.
Phase 33 holds the pool's single dispatch (Renderer(schedule="pool"),
fused by default: each sample window one launch of a CUDA graph whose
device-side WHILE node repeats one captured pool iteration,
csrc/graph_while.cu) against its host loop (fused=False), timed in turns
(tools/time_fused.py --pool): the bench render (u8 and f32 bit-equal,
24,259,990 segments, 62 K1 launches either way from the device
counters), bouncing_spheres_64 (64 K1 launches), perlin_sphere,
simple_light and earth (phase 20's pool counts) and BASELINE config 5
(25 windows of 20 spp, phase 28's segments), with walls, capture
seconds, host milliseconds a window's launch and peak device memory.
Every fused render after its capture runs under
torch.cuda.set_sync_debug_mode("error") until its copy to the host, so
a host read in a window's set-up or launch fails the phase. Phases 19,
20 and 22 render the pool fused (the default) and keep their checks
against the phased render.
Phase 34 holds the camera rays computed where they are used
(csrc/rt_camera.cuh) at the benchmark cells' launch shapes
(bouncing_spheres 1200x675 500 spp, cornell_box 600x600 100 spp;
Renderer's first launch, its last, padded and clamped, and a last block
one sample past spp) and three seeds (one past 2^31, one past 2^32): K1's start state
(a depth-0 launch started from the camera) against pack_rays of the
int64 camera rays on the card, K1's first phase started from the camera
against K1 fed those rays and against its plain version started from
the camera, and rt_camera_rays on a permuted (sorted-order) id list
against pack_replay_rays of the same rays, all bit for bit, with both
camera counters (K1_camera, camera_rays); then it times rt_camera_rays
against the int64 path and K1's first phase from the camera against K1
fed packed rays. Phase 4 also traces its phased launch started from the
camera, bit-equal to the rays' trace; phases 3, 6, 24, 25, 28, 31 and 32
count the camera starts (one a launch or chunk) and the replay's camera
launches (one a sweep chunk).
Phase 35 holds K1 with participating media (next_week_final, the
MEDIUM instantiation) against its plain version at that cell's launch
shape and times K1 on that launch with and without the media.

Kernels shorter than their wrappers' host time (K3, K4, the fold, the
BVH walk and the PyTorch calls beside them) are timed with their launches
queued behind a spin kernel (device_ms), the others over back-to-back
runs (cuda_ms).

Prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}. Exits
non-zero, without that line, when there is no CUDA device or any phase
fails. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

BENCH_SEGMENTS = 24_280_645  # bench workload's traced segments (JAX reference)
PORT_BENCH_SEGMENTS = 24_259_990  # the port's, in both schedules
POOL_BENCH_K1 = 62  # K1 launches (pool iterations) of the bench render through the pool
SEED = 7

# Bounds: the larger of operations over the card's FP32 peak and bytes
# over its memory rate (NVIDIA's H100 SXM data sheet, dense FP32 and HBM3).
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations, counted from the kernel sources (each add, multiply,
# compare, select, sqrt, divide, sin or cos as one; about ±20%):
K1_OPS_PER_SPHERE_ROW = 33   # moving sphere: oc 9, b 5, c 6, disc 3, sqrt, roots 3, tests 6
K1_OPS_PER_QUAD_ROW = 45
K1_OPS_SHADE = 150           # resolve, texture, PCG4D, scatter, bookkeeping per segment
K3_OPS_PER_SEGMENT = 300     # bounce_fwd with PCG4D
K2_OPS_PER_SEGMENT = 950     # bounce_fwd twice (sweep and recompute) + bounce_bwd
K5_OPS_PER_NODE = 28         # slab test: 6 sub, 6 mul, 12 min/max, compare, link select
K5_OPS_PER_SPHERE_MEMBER = 44  # center at time 6, oc 3, b 5, c 7, disc 3, sqrt 2, roots 5, tests 10, fold 3
K5_OPS_PER_QUAD_MEMBER = 66    # denom 5, plane t 8, point 9, alpha 14, beta 14, tests 11, fold 3
K5_OPS_SHADE = K1_OPS_SHADE  # the shared shading (rt_shade.cuh)
# per marble shade: 7 octaves of 3 floor, 3 sub, 3 cvt, 12 Hermite ops and 8
# corners of 6 index ops, 2 xor, 3 sub, 3 mul, 2 add, 3 weight mul, 1 acc;
# then 6 for the octave's sum and doubling; then sin and 4 more
K1_OPS_MARBLE = 7 * (21 + 8 * 20 + 6) + 5
K1_OPS_IMAGE = 40            # rxz 4, two atan2f, u v 4, clamps 6, texel index 8, 3 reads
# per camera ray (csrc/rt_camera.cuh): two PCG4D hashes of 28 integer
# operations, 4 draws of 3, the pixel's i and j 4, 3 axes of 4 for the
# pixel sample, the disk's sqrt, sin, cos and 4, its 3 axes of 4, the
# direction 3, the alive flag 2
CAMERA_OPS_PER_RAY = 2 * 28 + 4 * 3 + 4 + 12 + 7 + 12 + 3 + 2
# the benchmark cells' camera scenes at their sizes (benchmark/configs, traffic)
CAMERA_CELLS = {"bouncing_spheres": dict(image_width=1200, samples_per_pixel=500, max_depth=50),
                "cornell_box": dict(image_width=600, samples_per_pixel=100, max_depth=50)}
CAMERA_SEEDS = (SEED, 2**31 + 12345, 2**33 + 2**31 + 7)  # the last wraps to u32 as the RNG does


def segments_close(ref: int, s: int) -> bool:
    return abs(int(ref) - int(s)) <= max(4, int(ref) // 200)


def ptxas_summary(log):
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output: the
    kernel, its template switches, registers, stack and spills."""
    import re

    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(k\d_[a-z_]+?)(I|E)", m.group(1))
            name = k.group(1) if k else m.group(1)
            if k and k.group(2) == "I":  # the template's ints and bools, K5's Design<...> among them
                rest = m.group(1)[k.end():]
                name += "<" + ",".join(re.findall(r"L[ib](\d+)E", rest)) + ">"
        elif "stack frame" in line:
            frame = line.split(":", 1)[-1].strip()
        elif "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {frame}")
            name = None
    return out


def texture_shades(torch, fl, mega, ids):
    """(marble shades, image shades) in a launch, from its recorded global
    winner ids (max_depth, n), -1 on a miss or after death."""
    kid = mega.kid_map.long()
    col_of = torch.full((int(kid.max()) + 1,), -1, dtype=torch.long, device=kid.device)
    cols = torch.arange(kid.shape[0], device=kid.device)
    col_of[kid[kid >= 0]] = cols[kid >= 0]
    hit = ids[ids >= 0].long()
    tk = mega.table[fl.U_TKIND, col_of[hit]]
    return int((tk == fl.TK_NOISE).sum()), int((tk == fl.TK_IMAGE).sum())


@contextlib.contextmanager
def texels_read(mb):
    """Collects the atlas rows the plain shade fetches while the block
    runs: a list of (k,) index tensors, one per image-shading call."""
    read, image_texel = [], mb.image_texel

    def recording(*args):
        out = image_texel(*args)
        read.append(out[0])
        return out

    mb.image_texel = recording
    try:
        yield read
    finally:
        mb.image_texel = image_texel


def texel_boundary(torch, mb, fl, mega, ray_f, eps=1e-3):
    """(n,) bool: rays whose first hit is on an image-textured sphere within
    ``eps`` texels of a truncation boundary (u·w or (1 - v)·h near an
    integer), where an ulp of atan2 may pick the neighbouring texel."""
    t, ib = mb._closest_hit(mega, *ray_f[mb.OX:mb.TM + 1])
    hit = (t < mb.BIG) & (ray_f[mb.ACT] > 0.5)
    col = mega.table[:, ib.clamp(min=0)]
    sel = torch.nonzero(hit & (col[fl.U_TKIND] == fl.TK_IMAGE)
                        & (ib < mega.n_sph_pad)).flatten()
    col, tm = col[:, sel], ray_f[mb.TM, sel]
    p = [ray_f[mb.OX + k, sel] + t[sel] * ray_f[mb.DX + k, sel] for k in range(3)]
    inv_r = 1.0 / col[fl.U_G6]
    own = [(p[k] - (col[fl.U_G0 + k] + tm * col[fl.U_G3 + k])) * inv_r for k in range(3)]
    _, x, y = mb.image_texel(mega, ib[sel], *p, *own)

    def near(v):
        return torch.minimum(v - torch.floor(v), torch.ceil(v) - v) < eps

    out = torch.zeros(ray_f.shape[1], dtype=torch.bool, device=ray_f.device)
    out[sel[near(x) | near(y)]] = True
    return out


def bouncing_spheres_64(device, half=32):
    """The bench scene with its grid widened from 22x22 to 64x64 (the same
    rng stream, materials, camera and 3 big spheres; ~4,100 spheres, 514
    chunks of 8, so the trace walks the BVH in K5). Returns (scene, cfg)
    at 400x225, 100 spp, depth 20. ``half`` < 32 builds the
    (2 half)x(2 half) grid instead (phase 22's crossover)."""
    import numpy as np
    from raytracing_tpu_torch.render.camera import CameraConfig
    from raytracing_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    ground = b.lambertian(b.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.sphere((0.0, -1000.0, -1.0), 1000.0, ground)
    rng = np.random.default_rng(42)
    for a in range(-half, half):
        for bb in range(-half, half):
            choose_mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) > 0.9:
                if choose_mat < 0.8:
                    albedo = rng.random(3) * rng.random(3)
                    mat = b.lambertian(tuple(albedo))
                    center2 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
                    b.sphere(tuple(center), 0.2, mat, center2=tuple(center2))
                elif choose_mat < 0.95:
                    albedo = rng.uniform(0.5, 1.0, 3)
                    mat = b.metal(tuple(albedo), rng.uniform(0.0, 0.5))
                    b.sphere(tuple(center), 0.2, mat)
                else:
                    b.sphere(tuple(center), 0.2, b.dielectric(1.5))
    b.sphere((0.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.sphere((-4.0, 1.0, 0.0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.sphere((4.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))
    cfg = CameraConfig(aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100,
                       max_depth=20, background=(0.7, 0.8, 1.0), vfov=20.0,
                       lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0),
                       defocus_angle=0.6, focus_dist=10.0)
    return b.compile(device), cfg


def mixed_scene(device):
    """Spheres, a quad and emitters under a black sky (the JAX package's
    tests/test_megakernel.py test_bvh_mixed_scene), 32 px, depth 6."""
    from raytracing_tpu_torch.render.camera import CameraConfig
    from raytracing_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    b.sphere((0, -1000, 0), 1000.0, b.lambertian((0.6, 0.6, 0.2)))
    for i in range(24):
        b.sphere((i % 6 * 2 - 5, 0.5, i // 6 * 2 - 3), 0.5,
                 b.lambertian((0.2 + 0.03 * i, 0.4, 0.6)))
    light = b.diffuse_light((4.0, 4.0, 4.0))
    b.quad((3, 1, -2), (2, 0, 0), (0, 2, 0), light)
    b.sphere((0, 7, 0), 2.0, light)
    cfg = CameraConfig(image_width=32, aspect_ratio=1.0, samples_per_pixel=1, max_depth=6,
                       vfov=20.0, lookfrom=(26.0, 3.0, 6.0), lookat=(0.0, 2.0, 0.0),
                       background=(0.0, 0.0, 0.0))
    return b.compile(device), cfg


def first_launch(scene, cfg, n_block, spp_chunk, dev):
    """Camera rays of a render's first launch (n_block pixels ×
    spp_chunk samples), and the same rays as K1's packed inputs."""
    from raytracing_tpu_torch.ops.megakernel import pack_rays
    from raytracing_tpu_torch.render import camera as cam
    from raytracing_tpu_torch.render.renderer import chunk_rays

    derived = cam.derive(cfg, cam.CameraParams.from_config(cfg, dev))
    o, d, t, pix, smp, _, alive = chunk_rays(
        cfg, derived, 0, 0, SEED, n_block=n_block, spp_chunk=spp_chunk,
        has_moving=scene.flags.has_moving, device=dev)
    return (o, d, t, pix, smp, alive), pack_rays(o, d, t, pix, smp, alive)


def compare(torch, mb, exact, ref, out, n):
    """(ok, stats) for K1 outputs ``out`` against ``ref`` (each (rad,
    bounces, state[, ids])), with the JAX reference's bars."""
    diff = (out[0] - ref[0]).abs()
    s_ref, s_out = int(ref[1].sum()), int(out[1].sum())
    stats = dict(max_abs_err=float(diff.max()), mean_abs_err=float(diff.mean()),
                 segments=s_out, segments_plain=s_ref)
    ok = segments_close(s_ref, s_out)
    ok &= (stats["max_abs_err"] < 1e-5) if exact else (stats["mean_abs_err"] < 2e-3)
    if ref[2] is not None:
        rows = [mb.OX, mb.OY, mb.OZ, mb.DX, mb.DY, mb.DZ, mb.TR, mb.TG, mb.TB, mb.ACT]
        r, o = ref[2][rows], out[2][rows]
        bad = ((o - r).abs() > 1e-3 * torch.clamp(r.abs(), min=1.0)).any(0) | (ref[1] != out[1])
        stats["state_rays_disagreeing"] = int(bad.sum())
        ok &= stats["state_rays_disagreeing"] <= (n // 20 if not exact else max(4, n // 200))
    if len(ref) > 3:
        stats["ids_differing"] = int((out[3] != ref[3]).sum())
        ok &= stats["ids_differing"] == 0  # K1 is bit-equal to its plain version
    return bool(ok), stats


def bit_equal(torch, out, ref):
    """Whether two K1 outputs (rad, bounces, state or None[, ids]) are
    equal bit for bit."""
    return len(out) == len(ref) and all(
        (a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))
        for a, b in zip(out, ref))


def both_searches(torch, mb, args, kw, ref, reps=5):
    """K1 by the sweep and by the walk on one launch: for each, its output,
    whether it equals ``ref`` (the plain version's) bit for bit, and its
    device ms over ``reps`` launches."""
    res = {}
    for search, cull in (("sweep", False), ("walk", True)):
        out = mb.trace_block(*args, cull=cull, **kw)
        torch.cuda.synchronize()
        res[search] = dict(out=out, bit_equal=bit_equal(torch, out, ref), ms=cuda_ms(
            torch, lambda: mb.trace_block(*args, cull=cull, **kw), reps))
    return res


def searches_line(res):
    """The print of :func:`both_searches`."""
    return " ".join(f"{k} bit_equal {v['bit_equal']} {v['ms']:.3f} ms" for k, v in res.items())


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SPIN_CYCLES_PER_REP = 2_000_000  # ~1 ms of a 2 GHz card's clock for each queued run


def device_ms(torch, fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, queued behind
    a spin kernel (``torch.cuda._sleep``) so that the host's time between
    launches is hidden: the time of kernels shorter than their wrappers'
    host time, which :func:`cuda_ms` would measure instead. ``fn`` must not
    synchronize with the device."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES_PER_REP * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def onehot_reduce(torch, rk, g, ids, L, prefixes):
    """The JAX reference's table reduction, a one-hot matmul per bounce in
    full f32: timed beside the port's fold."""
    acc = torch.zeros((L, rk.NG), dtype=torch.float32, device=g.device)
    rows = torch.arange(L, device=g.device)
    for b in range(g.shape[0]):
        P = prefixes[b]
        acc += (rows[:, None] == ids[b, :P].clamp(min=0)[None, :]).float() @ g[b, :, :P].T
    tbar = torch.zeros((L, rk.rf.N_FIELDS), dtype=torch.float32, device=g.device)
    tbar[:, rk._TCOLS] = acc[:, rk._GSLOTS]
    return tbar


def index_add_reduce(torch, rk, g, ids, L, prefixes):
    """The port's table reduction before the fold: index_add_ per bounce
    (the fold's plain version), timed beside the fold."""
    acc = torch.zeros((L, rk.NG), dtype=g.dtype, device=g.device)
    for b in range(g.shape[0]):
        P = prefixes[b]
        acc.index_add_(0, ids[b, :P].clamp(min=0).long(), g[b, :, :P].T)
    tbar = torch.zeros((L, rk.rf.N_FIELDS), dtype=g.dtype, device=g.device)
    tbar[:, rk._TCOLS] = acc[:, rk._GSLOTS]
    return tbar


def timed(torch, fn):
    """(fn(), device milliseconds of that one call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time for ``ops`` FP32 operations
    and ``nbytes`` of memory traffic."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def launch_counts():
    """``(zero_counts, counts, only)`` over the kernels' launch counters
    (device-side, the wrappers' own): ``counts()`` the launches since
    ``zero_counts()`` by kernel, ``only(**kw)`` the counts of a run that
    launched only the kernels named. K1_camera counts the K1 launches
    started from the camera (among K1's), camera_rays the rt_camera_rays
    launches (the replay's rays)."""
    from raytracing_tpu_torch.diff import replay_kernel as rk
    from raytracing_tpu_torch.ops import megakernel_block as mb
    from raytracing_tpu_torch.ops import megakernel_group as mg
    from raytracing_tpu_torch.ops import table_gather as tg
    from raytracing_tpu_torch.ops import traverse

    counters = (("K1", mb.launches), ("K3", rk.fwd_launches), ("K2", rk.bwd_launches),
                ("K5", mg.launches), ("K4", tg.launches), ("fold", tg.fold_launches),
                ("walk", traverse.launches), ("K1_camera", mb.camera_launches),
                ("camera_rays", rk.camera_launches))

    def zero_counts():
        for _, count in counters:
            count.reset()

    def counts():
        return {k: int(count) for k, count in counters}

    def only(**kw):
        return {**{k: 0 for k, _ in counters}, **kw}

    return zero_counts, counts, only


def camera_launches(torch, dev):
    """Three launches of each camera cell (CAMERA_CELLS) at Renderer's
    launch shape: the render's first and its last (the last block, padded,
    its last pixels clamped and dead, of the last sample chunk), and the
    last block of a chunk that runs one sample past spp (all dead where a
    chunk holds one sample). Yields (name, launch, scene, cfg, mega,
    start, pix, smp, alive), ``start`` the cell's ``CameraStart``."""
    from raytracing_tpu_torch import Renderer, build
    from raytracing_tpu_torch.ops.megakernel import build_mega_scene
    from raytracing_tpu_torch.render import camera as cam
    from raytracing_tpu_torch.render.renderer import chunk_ids

    for name, shape in CAMERA_CELLS.items():
        scene, cfg = build(name, device=dev, **shape)
        r = Renderer(cfg)
        mega = build_mega_scene(scene)
        start = cam.CameraStart.of(cfg, cam.pack_camera(cam.derive(
            cfg, cam.CameraParams.from_config(cfg, dev))), scene.flags.has_moving)
        n_blocks, n_schunks = r._grid()
        p_last = (n_blocks - 1) * r.n_block
        for launch, p0, s0 in (("first", 0, 0),
                               ("last", p_last, (n_schunks - 1) * r.spp_chunk),
                               ("past spp", p_last, cfg.samples_per_pixel - r.spp_chunk + 1)):
            pix, smp, _, alive = chunk_ids(cfg, p0, s0, n_block=r.n_block,
                                           spp_chunk=r.spp_chunk, device=dev)
            yield name, launch, scene, cfg, mega, start, pix, smp, alive


def camera_rows(torch, dev):
    """Camera rays computed where they are used, against their plain
    versions on the same inputs, at each camera cell's two launches
    (:func:`camera_launches`) and CAMERA_SEEDS: K1's start state (a
    depth-0 launch started from the camera) against ``pack_rays`` of
    ``camera.rays`` (the int64 path, on the card); K1's first phase (2
    bounces, ids) started from the camera against K1 fed those packed
    rays and against ``trace_block_torch`` started from the camera; and
    ``rt_camera_rays`` on the ids in a permuted (sorted-order) list
    against ``pack_replay_rays`` of the same rays, all with
    ``torch.equal``. Per launch and seed: K1 3 launches (2 from the
    camera), ``rt_camera_rays`` 1. Returns one row per launch and seed."""
    from raytracing_tpu_torch.diff import replay_kernel as rk
    from raytracing_tpu_torch.ops import megakernel_block as mb

    rows = []
    for name, launch, scene, cfg, mega, start, pix, smp, alive in camera_launches(torch, dev):
        n = pix.numel()
        ray_i = torch.stack([pix, smp]).to(torch.int32)
        order = torch.randperm(n, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
        ids_s, alive_s = ray_i[:, order].contiguous(), alive[order]
        kw = dict(max_depth=2, background=cfg.background, want_ids=True)
        for seed in CAMERA_SEEDS:
            o, d, t = start.rays(pix, smp, seed)
            ray_f = mb.pack_rays(o, d, t, pix, smp, alive)[0]
            _, bc0, st0 = mb.trace_block(mega, None, ray_i, seed, 0, max_depth=0,
                                         background=cfg.background, camera=start, alive=alive)
            k_cam = mb.trace_block(mega, None, ray_i, seed, 0, camera=start, alive=alive, **kw)
            k_rays = mb.trace_block(mega, ray_f, ray_i, seed, 0, **kw)
            plain = mb.trace_block_torch(mega, None, ray_i, seed, 0, camera=start, alive=alive,
                                         **kw)
            got = rk.replay_rays(start, ids_s, alive_s, seed)
            want = rk.pack_replay_rays(o[order], d[order], t[order], alive_s)
            rows.append(dict(
                scene=name, launch=launch, seed=seed, B=n, alive=int(alive.sum()),
                pixels=cfg.n_pixels, pixel_max=int(pix.max()), spp=cfg.samples_per_pixel,
                samples=[int(smp.min()), int(smp.max())],
                start_state_equal=bool(torch.equal(st0, ray_f)) and int(bc0.sum()) == 0,
                k1_equal_packed=bit_equal(torch, k_cam, k_rays),
                k1_equal_plain=bit_equal(torch, k_cam, plain),
                replay_rays_equal=bool(torch.equal(got, want)),
                segments=int(k_cam[1].sum())))
    return rows


def camera_phase(torch, dev, card):
    """Phase 34: K1's start from the camera and rt_camera_rays against
    their plain versions on the same inputs, bit for bit
    (:func:`camera_rows`), with the launches counted; then timed against
    the int64 path they replace (:func:`camera_times`). Prints a line a
    row and one for the phase; returns ``(ok, rows, times)``."""
    zero_counts, counts, only = launch_counts()
    zero_counts()
    rows = camera_rows(torch, dev)
    torch.cuda.synchronize()
    c = counts()
    ok_all = c == only(K1=3 * len(rows), K1_camera=2 * len(rows), camera_rays=len(rows))
    for row in rows:
        ok = (row["start_state_equal"] and row["k1_equal_packed"] and row["k1_equal_plain"]
              and row["replay_rays_equal"] and (row["segments"] > 0) == (row["alive"] > 0))
        if row["launch"] == "last":  # padded, its last pixels clamped and dead
            ok &= row["pixel_max"] == row["pixels"] - 1 and 0 < row["alive"] < row["B"]
        if row["launch"] == "past spp":
            ok &= row["samples"][1] >= row["spp"]
        print(f"phase 34 camera rays {row['scene']} {row['launch']} launch seed {row['seed']}: "
              f"{'ok' if ok else 'FAIL'} {json.dumps(row)} [{card}]")
        ok_all &= ok
    times = camera_times(torch, dev)
    print(f"phase 34 camera rays: {'ok' if ok_all else 'FAIL'} kernel launches {c} (expected "
          f"K1 {3 * len(rows)}, K1_camera {2 * len(rows)}, camera_rays {len(rows)}) "
          f"times {json.dumps(times)} [{card}]")
    return bool(ok_all), rows, times


def camera_times(torch, dev, reps=20):
    """Device ms of the camera rays on the first launch of each camera
    cell at SEED: ``rt_camera_rays`` on the sorted-order ids (queued
    behind a spin kernel, :func:`device_ms`) against its plain version
    (``pack_replay_rays`` of ``camera.rays``, about 250 int64 kernels,
    back to back), with its bound; and K1's first phase (2 bounces, the
    walk or sweep its scene takes) started from the camera against K1 fed
    the packed rays, back to back."""
    from raytracing_tpu_torch.diff import replay_kernel as rk
    from raytracing_tpu_torch.ops import megakernel_block as mb

    rows = {}
    for name, launch, scene, cfg, mega, start, pix, smp, alive in camera_launches(torch, dev):
        if launch != "first":
            continue
        n = pix.numel()
        ray_i = torch.stack([pix, smp]).to(torch.int32)
        order = torch.randperm(n, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
        ids_s, alive_s = ray_i[:, order].contiguous(), alive[order]
        ray_f = mb.pack_rays(*start.rays(pix, smp, SEED), pix, smp, alive)[0]
        kw = dict(max_depth=2, background=cfg.background)
        b = bound(n * CAMERA_OPS_PER_RAY, n * (2 * 4 + 1 + rk.N_RAY_F * 4) + 4 * 18)
        rows[name] = dict(
            B=n, ms=device_ms(torch, lambda: rk.replay_rays(start, ids_s, alive_s, SEED), reps),
            plain_ms=cuda_ms(torch, lambda: rk.pack_replay_rays(
                *start.rays(ids_s[0], ids_s[1], SEED), alive_s), 5),
            bound_ms=b[0], bound_by=b[1],
            k1_camera_ms=cuda_ms(torch, lambda: mb.trace_block(
                mega, None, ray_i, SEED, 0, camera=start, alive=alive, **kw), 5),
            k1_packed_ms=cuda_ms(torch, lambda: mb.trace_block(mega, ray_f, ray_i, SEED, 0, **kw),
                                 5))
    return rows


MEDIUM_SHAPE = dict(samples_per_pixel=250)  # next_week_final as its cell runs it (800x800, depth 40)


def medium_phase(torch, dev, card, reps=3):
    """Phase 35: K1 with participating media on next_week_final (the
    MEDIUM instantiation, with motion, marble, image and the walk) against
    its plain version at the cell's launch shape, bit for bit with the
    medium scatters counted equal: the first launch's first phase of 2
    bounces from the camera, then its other 38 bounces from that state.
    Then K1 on the full first launch (40 bounces from the camera) timed
    with the media and on the same scene built without them (``media=
    False``), back to back, and one small render through Renderer's
    defaults, whose launches must be K1's alone. Prints a line a check;
    returns ``(ok, row)``."""
    from raytracing_tpu_torch import Renderer, build
    from raytracing_tpu_torch.ops import megakernel_block as mb
    from raytracing_tpu_torch.ops.megakernel import build_mega_scene
    from raytracing_tpu_torch.render import camera as cam
    from raytracing_tpu_torch.render.renderer import chunk_ids

    zero_counts, counts, only = launch_counts()
    row, ok = {}, True
    starts = {}
    for media in (True, False):
        scene, cfg = build("next_week_final", device=dev, media=media, **MEDIUM_SHAPE)
        r = Renderer(cfg)
        mega = build_mega_scene(scene)
        start = cam.CameraStart.of(cfg, cam.pack_camera(cam.derive(
            cfg, cam.CameraParams.from_config(cfg, dev))), scene.flags.has_moving)
        pix, smp, _, alive = chunk_ids(cfg, 0, 0, n_block=r.n_block, spp_chunk=r.spp_chunk,
                                       device=dev)
        starts[media] = (mega, start, torch.stack([pix, smp]).to(torch.int32), alive, cfg)
    mega, start, ray_i, alive, cfg = starts[True]
    outs = {}
    for name, fn in (("kernel", mb.trace_block), ("plain", mb.trace_block_torch)):
        mb.medium_scatters.reset()
        first = fn(mega, None, ray_i, SEED, 0, max_depth=2, background=cfg.background,
                   camera=start, alive=alive)
        rest = fn(mega, first[2], ray_i, SEED, 2, max_depth=cfg.max_depth - 2,
                  background=cfg.background)
        torch.cuda.synchronize()
        outs[name] = (*first, *rest, int(mb.medium_scatters))
    k, p = outs["kernel"], outs["plain"]
    row["bit_equal"] = all(torch.equal(a, b) for a, b in zip(k[:-1], p[:-1]))
    row["B"], row["segments"] = ray_i.shape[1], int(k[1].sum() + k[4].sum())
    row["medium_scatters"], row["plain_medium_scatters"] = k[-1], p[-1]
    ok &= row["bit_equal"] and k[-1] == p[-1] > 0
    for media, (mega_m, start_m, ray_i_m, alive_m, cfg_m) in starts.items():
        def run(mega_m=mega_m, start_m=start_m, ray_i_m=ray_i_m, alive_m=alive_m, cfg_m=cfg_m):
            return mb.trace_block(mega_m, None, ray_i_m, SEED, 0, max_depth=cfg_m.max_depth,
                                  background=cfg_m.background, camera=start_m, alive=alive_m)

        key = "with_media" if media else "without_media"
        row[f"k1_ms_{key}"] = cuda_ms(torch, run, reps)
        row[f"segments_{key}"] = int(run()[1].sum())
        row[f"ns_per_segment_{key}"] = 1e6 * row[f"k1_ms_{key}"] / row[f"segments_{key}"]
    scene, cfg = build("next_week_final", device=dev, image_width=160, samples_per_pixel=4)
    zero_counts()
    res = Renderer(cfg).render(scene, seed=SEED)
    c = counts()
    row["render_160"] = dict(segments=res.segments, counts=c)
    ok &= (c == only(K1=c["K1"], K1_camera=c["K1_camera"]) and c["K1"] > 0
           and c["K1"] == 3 * c["K1_camera"] and res.segments > 0)
    print(f"phase 35 next_week_final K1 with media: {'ok' if ok else 'FAIL'} {json.dumps(row)} "
          f"[{card}]")
    return bool(ok), row


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from raytracing_tpu_torch import Renderer, _kernels, build
    from raytracing_tpu_torch import bench as pbench
    from raytracing_tpu_torch.diff import replay_fast as rf
    from raytracing_tpu_torch.diff import replay_kernel as rk
    from raytracing_tpu_torch.ops import megakernel_block as mb
    from raytracing_tpu_torch.ops import megakernel_group as mg
    from raytracing_tpu_torch.ops import table_gather as tg
    from raytracing_tpu_torch.ops import traverse
    from raytracing_tpu_torch.ops.intersect import sqrt_rn
    from raytracing_tpu_torch.ops.megakernel import (build_mega_scene, select_layout,
                                                     trace_megakernel)
    from raytracing_tpu_torch.render import camera as cam
    from raytracing_tpu_torch.render import pool as pool_mod
    from torch_parity import sqrt_grads, sqrt_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    zero_counts, counts, only = launch_counts()

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    k = _kernels.library()
    print(f"phase 1 build: nvcc {k.build_seconds:.2f} s, load {time.perf_counter() - t0:.2f} s "
          f"({k.path.name})")
    for line in ptxas_summary(k.build_log):
        print(f"  ptxas: {line}")

    failures = []

    # ---- phase 2: K1 against the plain version, small launches ----
    for name, exact in (("three_spheres", True), ("cornell_box", True),
                        ("bouncing_spheres", False)):
        scene, cfg = build(name, device=dev, image_width=64, samples_per_pixel=2, max_depth=6)
        mega = build_mega_scene(scene)
        n_block = -(-cfg.n_pixels // 1024) * 1024
        _, (ray_f, ray_i) = first_launch(scene, cfg, n_block, 2, dev)
        for b_off in (0, 3):
            args = (mega, ray_f, ray_i, SEED, b_off)
            kw = dict(max_depth=6, background=cfg.background, want_ids=True)
            ref = mb.trace_block_torch(*args, **kw)
            both = both_searches(torch, mb, args, kw, ref)
            ok, stats = compare(torch, mb, exact, ref, both["walk"]["out"], ray_f.shape[1])
            ok &= all(v["bit_equal"] for v in both.values())
            print(f"phase 2 {name} b_off={b_off} B={ray_f.shape[1]}: "
                  f"{'ok' if ok else 'FAIL'} {json.dumps(stats)} {searches_line(both)}")
            if not ok:
                failures.append(f"phase 2 {name} b_off={b_off}")

    # ---- phase 3: the bench render through Renderer ----
    scene, cfg = build("bouncing_spheres", device=dev, image_width=400,
                       samples_per_pixel=100, max_depth=20)
    kw = dict(hit_method="mega", max_rays_per_launch=1 << 18, transfer="u8",
              phase_depths=[2, 2, 3, 4, cfg.max_depth - 11])
    t0 = time.perf_counter()
    zero_counts()
    pref = Renderer(cfg, **kw).plan_phase_prefixes(scene, seed=SEED)
    plan_counts = counts()
    print(f"phase 3 plan: prefixes {pref} in {time.perf_counter() - t0:.2f} s "
          f"kernel launches {plan_counts}")
    r = Renderer(cfg, **kw, phase_prefixes=pref)
    r.render(scene, seed=SEED)  # warm-up: allocator and CUDA libraries
    zero_counts()
    res = r.render(scene, seed=SEED)
    render_counts = counts()
    runs = [res] + [r.render(scene, seed=SEED) for _ in range(2)]
    best = min(runs, key=lambda x: x.seconds)
    img = res.u8
    # one K1 launch per phase of every chunk: 5 × 50 = 250, the first
    # phase of each started from the camera
    render_ok = (res.ok is True
                 and render_counts == only(K1=5 * res.launches, K1_camera=res.launches)
                 and segments_close(BENCH_SEGMENTS, res.segments)
                 and res.segments == PORT_BENCH_SEGMENTS
                 and all(x.segments == res.segments for x in runs)
                 and img.shape == (cfg.image_height, cfg.image_width, 3)
                 and 20 < float(img.mean()) < 235)
    print(f"phase 3 render: {'ok' if render_ok else 'FAIL'} segments {res.segments} "
          f"(reference {BENCH_SEGMENTS}) launches {res.launches} kernel launches {render_counts} "
          f"ok {res.ok} seconds {[round(x.seconds, 4) for x in runs]} "
          f"best {best.seconds:.4f} s {best.segments / best.seconds:.4g} rays/s "
          f"image mean {float(img.mean()):.2f} [{card}]")
    if not render_ok:
        failures.append("phase 3 bench render")

    small = dict(image_width=48, samples_per_pixel=2, max_depth=8)
    s_gpu, c_gpu = build("bouncing_spheres", device=dev, **small)
    s_cpu, c_cpu = build("bouncing_spheres", device="cpu", **small)
    g = Renderer(c_gpu, phase_depths=[2, 2, 4]).render(s_gpu, seed=SEED)
    c = Renderer(c_cpu, phase_depths=[2, 2, 4]).render(s_cpu, seed=SEED)
    mean_err = float(abs(g.radiance - c.radiance).mean())
    small_ok = mean_err < 2e-3 and segments_close(c.segments, g.segments)
    print(f"phase 3 small render card vs cpu: {'ok' if small_ok else 'FAIL'} "
          f"mean_abs_err {mean_err:.3g} segments {g.segments} cpu {c.segments}")
    if not small_ok:
        failures.append("phase 3 small render")

    # ---- phase 4: K1 against the plain version on one full-width launch ----
    mega = build_mega_scene(scene)
    (o, d, t, pix, smp, alive), (ray_f, ray_i) = first_launch(scene, cfg, r.n_block,
                                                              r.spp_chunk, dev)
    B = ray_f.shape[1]
    args = (mega, ray_f, ray_i, SEED, 0)
    kw4 = dict(max_depth=cfg.max_depth, background=cfg.background)
    ref = mb.trace_block_torch(*args, **kw4)
    both4 = both_searches(torch, mb, args, kw4, ref)
    ok4, stats = compare(torch, mb, False, ref, both4["walk"]["out"], B)
    ok4 &= all(v["bit_equal"] for v in both4.values())
    ms, ms_sweep = both4["walk"]["ms"], both4["sweep"]["ms"]
    plain_ms = cuda_ms(torch, lambda: mb.trace_block_torch(*args, **kw4), 2)
    # the sweep tests the real rows (mega.n_sph, mega.n_quad); the walk's
    # bound comes from K5's plain walk on this launch (phase 9)
    k1_sweep_bound = bound(
        stats["segments"] * (K1_OPS_PER_SPHERE_ROW * mega.n_sph + K1_OPS_PER_QUAD_ROW * mega.n_quad
                             + K1_OPS_SHADE),
        B * (mb.N_F * 4 * 2 + 8 + 12 + 4)
        + 4 * (8 * mega.n_sph + 16 * mega.n_quad + mega.resolve.numel() + mega.kid_map.numel()))
    print(f"phase 4 single launch B={B} depth {cfg.max_depth}: {'ok' if ok4 else 'FAIL'} "
          f"{json.dumps(stats)} {searches_line(both4)} plain {plain_ms:.3f} ms "
          f"sweep bound {k1_sweep_bound[0]:.4f} ms ({k1_sweep_bound[1]}, {mega.n_sph} rows) "
          f"[{card}]")
    del both4
    if not ok4:
        failures.append("phase 4 single launch")

    phased = dict(phase_depths=kw["phase_depths"], active0=alive)
    trace_args = (mega, o, d, t, pix, smp, cfg.background, cfg.max_depth, SEED)
    zero_counts()
    rad_k, seg_k = trace_megakernel(*trace_args, **phased)
    torch.cuda.synchronize()
    rays4_counts = counts()
    rad_p, seg_p = trace_megakernel(*trace_args, **phased, plain=True)
    err = float((rad_k - rad_p).abs().mean())
    # the same trace started from the camera (the renders' and the
    # sweeps' start): bit-equal, its first phase's launch counted
    start4 = cam.CameraStart.of(cfg, cam.pack_camera(cam.derive(
        cfg, cam.CameraParams.from_config(cfg, dev))), scene.flags.has_moving)
    zero_counts()
    rad_c, seg_c = trace_megakernel(mega, None, None, None, *trace_args[4:], **phased,
                                    camera=start4)
    torch.cuda.synchronize()
    cam4_counts = counts()
    n_ph = len(kw["phase_depths"])
    ph_ok = (err < 2e-3 and segments_close(int(seg_p), int(seg_k))
             and bool(torch.equal(rad_c, rad_k)) and bool(torch.equal(seg_c, seg_k))
             and rays4_counts == only(K1=n_ph) and cam4_counts == only(K1=n_ph, K1_camera=1))
    ph_ms = cuda_ms(torch, lambda: trace_megakernel(*trace_args, **phased), 5)
    ph_cam_ms = cuda_ms(torch, lambda: trace_megakernel(
        mega, None, None, None, *trace_args[4:], **phased, camera=start4), 5)
    ph_plain_ms = cuda_ms(torch, lambda: trace_megakernel(
        *trace_args, **phased, plain=True), 2)
    print(f"phase 4 phased launch {kw['phase_depths']} B={B}: {'ok' if ph_ok else 'FAIL'} "
          f"mean_abs_err {err:.3g} segments {int(seg_k)} plain {int(seg_p)} "
          f"from the camera bit-equal {bool(torch.equal(rad_c, rad_k))} kernel launches "
          f"{rays4_counts}, from the camera {cam4_counts} kernel {ph_ms:.3f} ms, from the "
          f"camera {ph_cam_ms:.3f} ms, plain {ph_plain_ms:.3f} ms [{card}]")
    if not ph_ok:
        failures.append("phase 4 phased launch")

    # ---- phase 5: K3 and K2 against their plain versions ----
    def replay_inputs(scene_r, cfg_r, spp_chunk, phases):
        """A decision pass on the card (K1, compacted ids, counts) over
        one chunk, then its rays sorted by recorded length as
        replay_grads_sorted sorts them: the replay kernels' inputs."""
        n_pix = cfg_r.n_pixels
        npix_pad = -(-n_pix // 1024) * 1024
        n = npix_pad * spp_chunk
        D = cfg_r.max_depth
        pix_r = torch.clamp(torch.arange(npix_pad, device=dev), max=n_pix - 1).repeat(spp_chunk)
        smp_r = torch.arange(spp_chunk, device=dev).repeat_interleave(npix_pad)
        act_r = (torch.arange(npix_pad, device=dev) < n_pix).repeat(spp_chunk)
        der = cam.derive(cfg_r, cam.CameraParams.from_config(cfg_r, dev))
        o_r, d_r, t_r = cam.generate_rays(cfg_r, der, pix_r, smp_r, SEED,
                                          motion_blur=scene_r.flags.has_moving)
        _, seg, ids, cnt = trace_megakernel(
            build_mega_scene(scene_r), o_r, d_r, t_r, pix_r, smp_r, cfg_r.background, D, SEED,
            phase_depths=phases, active0=act_r, want_ids=True, want_counts=True)
        order = torch.argsort((D - cnt.long()) * n + torch.arange(n, device=dev))
        len_s = cnt[order]
        ray_f_r = rk.pack_replay_rays(o_r[order], d_r[order], t_r[order], len_s > 0)
        ray_i_r = torch.stack([pix_r[order], smp_r[order]]).to(torch.int32)
        rad_bar = torch.from_numpy(
            np.random.default_rng(3).normal(size=(3, n)).astype(np.float32)).to(dev)
        table = rf.build_replay_table(scene_r).detach()
        kw_r = dict(seed=SEED, n_sph=scene_r.n_spheres, has_moving=scene_r.flags.has_moving,
                    background=cfg_r.background)
        return (table, ids[:, order].contiguous(), ray_f_r, ray_i_r, rk.tile_maxlen(len_s, D),
                rad_bar, kw_r, int(seg), len_s)

    for name, exact in (("three_spheres", True), ("cornell_box", True),
                        ("bouncing_spheres", False)):
        scene_r, cfg_r = build(name, device=dev, image_width=64, samples_per_pixel=2,
                               max_depth=6)
        table, ids, rfr, rir, ml, rbar, kw_r, seg, _ = replay_inputs(scene_r, cfg_r, 2,
                                                                     [2, 2, 2])
        rad_k3, bc_k3 = rk.replay_fwd(table, ids, rfr, rir, ml, **kw_r)
        g_k2 = rk.replay_bwd(table, ids, rfr, rir, rbar, ml, **kw_r)
        torch.cuda.synchronize()
        rad_p3, bc_p3 = rk.replay_fwd_torch(table, ids, rfr, rir, ml, **kw_r)
        g_p2 = rk.replay_bwd_torch(table, ids, rfr, rir, rbar, ml, **kw_r)
        d3 = (rad_k3 - rad_p3).abs()
        L = table.shape[0]
        tb_k = rk.reduce_table_grads(g_k2.cpu(), ids.cpu(), L)
        tb_p = rk.reduce_table_grads(g_p2.cpu(), ids.cpu(), L)
        ok3 = ((float(d3.max()) < 1e-5) if exact else (float(d3.mean()) < 2e-3)) and \
            segments_close(int(bc_p3.sum()), int(bc_k3.sum()))
        ok2 = bool(torch.allclose(tb_k, tb_p, rtol=3e-5, atol=3e-6))
        print(f"phase 5 {name} B={rfr.shape[1]}: K3 {'ok' if ok3 else 'FAIL'} max_abs_err "
              f"{float(d3.max()):.3g} mean {float(d3.mean()):.3g} segments {int(bc_k3.sum())} "
              f"plain {int(bc_p3.sum())} decision {seg}; K2 {'ok' if ok2 else 'FAIL'} tbar "
              f"max_abs_err {float((tb_k - tb_p).abs().max()):.3g} "
              f"bitwise_equal_g {bool(torch.equal(g_k2, g_p2))}")
        if not ok3:
            failures.append(f"phase 5 K3 {name}")
        if not ok2:
            failures.append(f"phase 5 K2 {name}")

    # one full-width depth-20 chunk of the fwd+bwd workload (spp_chunk 4)
    table, ids, rfr, rir, ml, rbar, kw_r, seg_dec, len_s = replay_inputs(
        scene, cfg, 4, kw["phase_depths"])
    n_full = rfr.shape[1]
    rad_k3, bc_k3 = rk.replay_fwd(table, ids, rfr, rir, ml, **kw_r)
    rad_p3, bc_p3 = rk.replay_fwd_torch(table, ids, rfr, rir, ml, **kw_r)
    d3 = (rad_k3 - rad_p3).abs()
    seg_k3 = int(bc_k3.sum())
    ok3 = seg_k3 == int(bc_p3.sum()) and float(d3.mean()) < 2e-3
    k3_ms = device_ms(torch, lambda: rk.replay_fwd(table, ids, rfr, rir, ml, **kw_r), 10)
    k3_plain_ms = cuda_ms(torch, lambda: rk.replay_fwd_torch(table, ids, rfr, rir, ml, **kw_r), 2)
    D = cfg.max_depth
    k3_bound = bound(seg_k3 * K3_OPS_PER_SEGMENT,
                     n_full * (rk.N_RAY_F * 4 + 8 + 12 + 4) + 4 * seg_k3 + 4 * table.numel())
    # K3's probe on the same chunk: the design before the refill (one thread
    # per ray) against K3's in turns, both bit-equal to K3, and the counting
    # instantiation of each (the share of a warp's lanes busy at a bounce)
    k3_probe = {}
    for design in ("baseline", "refill", "refill", "baseline"):
        def run_k3(design=design, count=False):
            return rk.replay_fwd_probe(table, ids, rfr, rir, ml, design=design, count=count,
                                       **kw_r)

        pr = k3_probe.setdefault(design, dict(ms=[]))
        pr["ms"].append(device_ms(torch, run_k3, 10))
        if "lanes" not in pr:
            (r1, b1, _), (r2, b2, c) = run_k3(), run_k3(count=True)
            pr["bit_equal"] = all(torch.equal(x, y) for x, y in
                                  ((r1, rad_k3), (r2, rad_k3), (b1, bc_k3), (b2, bc_k3)))
            pr["bounces"] = c["bounces"]
            pr["lanes"] = c["bounces"] / (32 * c["issues"])
    ok3 &= all(v["bit_equal"] and v["bounces"] == seg_k3 for v in k3_probe.values())
    print(f"phase 5 full chunk B={n_full} depth {D}: K3 {'ok' if ok3 else 'FAIL'} segments "
          f"{seg_k3} plain {int(bc_p3.sum())} decision {seg_dec} max_abs_err "
          f"{float(d3.max()):.3g} mean {float(d3.mean()):.3g} kernel {k3_ms:.3f} ms plain "
          f"{k3_plain_ms:.3f} ms bound {k3_bound[0]:.4f} ms ({k3_bound[1]}); probe " + "; ".join(
              f"{d} {' '.join(f'{x:.4f}' for x in v['ms'])} ms, bit_equal {v['bit_equal']}, "
              f"bounces counted {v['bounces']}, lanes busy {v['lanes']:.3f} of a warp"
              for d, v in k3_probe.items()) + f" [{card}]")
    if not ok3:
        failures.append("phase 5 K3 full chunk")

    g_k2 = rk.replay_bwd(table, ids, rfr, rir, rbar, ml, **kw_r)
    g_p2 = rk.replay_bwd_torch(table, ids, rfr, rir, rbar, ml, **kw_r)
    L = table.shape[0]
    tb_k = rk.reduce_table_grads(g_k2, ids, L)
    tb_p = rk.reduce_table_grads(g_p2, ids, L)
    rel2 = float((tb_k - tb_p).norm() / tb_p.norm())
    k2_err = float((tb_k - tb_p).abs().max())
    ok2 = rel2 < 1e-4 and bool(torch.isfinite(g_k2).all())
    del g_p2
    k2_ms = cuda_ms(torch, lambda: rk.replay_bwd(table, ids, rfr, rir, rbar, ml, **kw_r), 3)
    k2_plain_ms = cuda_ms(torch, lambda: rk.replay_bwd_torch(table, ids, rfr, rir, rbar, ml,
                                                             **kw_r), 1)
    k2_bound = bound(seg_k3 * K2_OPS_PER_SEGMENT,
                     n_full * (rk.N_RAY_F * 4 + 8 + 12 + 4) + 4 * seg_k3 + 4 * table.numel()
                     + 4 * g_k2.numel())
    print(f"phase 5 full chunk: K2 {'ok' if ok2 else 'FAIL'} tbar relative L2 error {rel2:.3g} "
          f"max_abs_err {k2_err:.3g} kernel {k2_ms:.3f} ms plain {k2_plain_ms:.3f} ms "
          f"bound {k2_bound[0]:.4f} ms ({k2_bound[1]}) output {g_k2.numel() * 4 / 1e6:.0f} MB "
          f"[{card}]")
    if not ok2:
        failures.append("phase 5 K2 full chunk")

    # the table reduction over the planned prefixes: the fold (the port's,
    # one launch) against index_add_ per bounce and the reference's one-hot
    # matmul, each against a float64 sum
    prefixes = rk.plan_prefixes(torch.bincount(len_s.long(), minlength=D + 1).cpu(), n_full, D,
                                margin=1.0)
    before = int(tg.fold_launches)
    red_fold = rk.reduce_table_grads(g_k2, ids, L, prefixes)
    torch.cuda.synchronize()
    ok5r = int(tg.fold_launches) == before + 1
    red64 = index_add_reduce(torch, rk, g_k2.double(), ids, L, prefixes)
    reds = dict(fold=red_fold, index_add_=index_add_reduce(torch, rk, g_k2, ids, L, prefixes),
                onehot=onehot_reduce(torch, rk, g_k2, ids, L, prefixes))
    red_err = {k: float((v.double() - red64).abs().max()) for k, v in reds.items()}
    red_rel = float((red_fold.double() - red64).norm() / red64.norm())
    red_atol = 2e-6 * max(1, sum(prefixes) // L)  # phase 11's bar, at this fold's rays per row
    ok5r &= bool(torch.allclose(red_fold.double(), red64, rtol=1e-5, atol=red_atol))
    red_ms = dict(fold=device_ms(torch, lambda: tg.fold(g_k2, ids, L, prefixes), 10),
                  index_add_=device_ms(torch, lambda: index_add_reduce(torch, rk, g_k2, ids, L,
                                                                       prefixes), 5),
                  onehot=device_ms(torch, lambda: onehot_reduce(torch, rk, g_k2, ids, L,
                                                                prefixes), 3),
                  reduce_table_grads_wall=cuda_ms(torch, lambda: rk.reduce_table_grads(
                      g_k2, ids, L, prefixes), 5))
    fold_rays = sum(prefixes)
    red_bound = bound(fold_rays * rk.NG, 4 * (fold_rays * (rk.NG + 1) + L * rk.NG))
    print(f"phase 5 table reduction over planned prefixes ({fold_rays} ray-bounces): "
          f"{'ok' if ok5r else 'FAIL'} ms {json.dumps(red_ms)} (fold: the port's, one launch, "
          f"device time; index_add_ per bounce and one-hot matmul: references; "
          f"reduce_table_grads_wall: the whole call, host included); max abs error against "
          f"float64 {json.dumps(red_err)}, fold relative L2 {red_rel:.3g} (bar rtol 1e-5, atol "
          f"{red_atol:.3g}); bound {red_bound[0]:.4f} ms ({red_bound[1]}) [{card}]")
    if not ok5r:
        failures.append("phase 5 table reduction")
    del g_k2, reds, red64

    # ---- phase 6: the fwd+bwd bench ----
    # bench_fwd_bwd's steps, with the kernels' launches counted over one
    # sweep (25 chunks: 5 decision phases each, one K2 each)
    t0 = time.perf_counter()
    fbs = pbench._fwd_bwd_setup(device=dev)
    fbs["plan"]()
    fbs["sweep"]()  # warm-up
    zero_counts()
    _, _, _, sweep_segs, sweep_ok = fbs["sweep"]()
    torch.cuda.synchronize()
    fb_counts = counts()
    fb = pbench.time_fwd_bwd(fbs, reps=3)
    fb_wall = time.perf_counter() - t0
    n_chunks = fbs["n_chunks"]
    fb_ok = (fb_counts == only(K1=5 * n_chunks, K2=n_chunks, fold=n_chunks, K1_camera=n_chunks,
                               camera_rays=n_chunks) and bool(sweep_ok)
             and int(sweep_segs) == fb["segments"]
             and fb["segments"] == res.segments and segments_close(BENCH_SEGMENTS, fb["segments"])
             and fb["grads_finite"] and float(fb["grad_rgb"].abs().sum()) > 0)
    print(f"phase 6 fwd+bwd bench: {'ok' if fb_ok else 'FAIL'} segments {fb['segments']} "
          f"(forward render {res.segments}, reference {BENCH_SEGMENTS}) best {fb['seconds']:.4f} s "
          f"{fb['rays_per_s']:.4g} rays/s loss {fb['loss']:.6g} kernel launches in one sweep "
          f"{fb_counts} (expected K1 {5 * n_chunks}, K2, fold, K1_camera and camera_rays "
          f"{n_chunks}) (call "
          f"{fb_wall:.1f} s) [{card}]")
    if not fb_ok:
        failures.append("phase 6 fwd+bwd bench")

    # ---- phase 7: replay_trace_kernel, K3 forward and K2 backward ----
    rgb = scene.textures.rgb.clone().requires_grad_(True)
    scene_g = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, rgb=rgb))
    o_s, d_s, t_s = rfr[rk.RX:rk.RZ + 1].T, rfr[rk.RDX:rk.RDZ + 1].T, rfr[rk.RTM]
    zero_counts()
    rad_t, seg_t = rk.replay_trace_kernel(scene_g, ids, o_s, d_s, t_s, rir[0], rir[1],
                                          cfg.background, D, SEED, active0=rfr[rk.RACT] > 0,
                                          lengths=len_s)
    (rad_t * rbar.T).sum().backward()
    torch.cuda.synchronize()
    rt_counts = counts()
    rt_ok = (rt_counts == only(K3=1, K2=1, fold=1) and int(seg_t) == seg_k3
             and bool(torch.equal(rad_t.detach(), rad_k3.T))
             and bool(torch.isfinite(rgb.grad).all()))
    print(f"phase 7 replay_trace_kernel: {'ok' if rt_ok else 'FAIL'} segments {int(seg_t)} "
          f"kernel launches {rt_counts} rgb grad norm {float(rgb.grad.norm()):.4g}")
    if not rt_ok:
        failures.append("phase 7 replay_trace_kernel")

    # ---- phase 8: K5 against its plain version on small scenes ----
    def group_launch(scene_g, cfg_g, spp):
        n_block = -(-cfg_g.n_pixels // 1024) * 1024
        _, rays = first_launch(scene_g, cfg_g, n_block, spp, dev)
        return build_mega_scene(scene_g), rays

    def equal_outputs(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    small_scenes = [("three_spheres", *build("three_spheres", device=dev, image_width=64,
                                              samples_per_pixel=2, max_depth=6), 2, 6),
                    ("cornell_box", *build("cornell_box", device=dev, image_width=64,
                                          samples_per_pixel=2, max_depth=6), 2, 6),
                    ("bouncing_spheres", *build("bouncing_spheres", device=dev, image_width=64,
                                               samples_per_pixel=2, max_depth=8), 2, 8),
                    ("mixed", *mixed_scene(dev), 1, 6)]
    for name, scene_s, cfg_s, spp, depth in small_scenes:
        mega_s, (ray_f, ray_i) = group_launch(scene_s, cfg_s, spp)
        outs = {}
        ok8 = True
        for use_bvh in (True, False):
            kw8 = dict(max_depth=depth, background=cfg_s.background, use_bvh=use_bvh)
            before = int(mg.launches)
            out = mg.trace_group(mega_s, ray_f, ray_i, SEED, 3, **kw8)
            torch.cuda.synchronize()
            ref = mg.trace_group_torch(mega_s, ray_f, ray_i, SEED, 3, **kw8)
            ok8 &= int(mg.launches) == before + 1 and equal_outputs(out, ref)
            outs[use_bvh] = out
        walk_eq_sweep = equal_outputs(outs[True], outs[False])
        ok8 &= walk_eq_sweep and int(outs[True][1].sum()) > 0
        print(f"phase 8 {name} B={ray_f.shape[1]} depth {depth}: {'ok' if ok8 else 'FAIL'} "
              f"walk and sweep bit-equal to plain, walk == sweep {walk_eq_sweep}, segments "
              f"{int(outs[True][1].sum())}, nodes {mega_s.nodes.shape[0]}")
        if not ok8:
            failures.append(f"phase 8 {name}")

    # ---- phase 9: one full-width launch, K5 against plain and against K1 ----
    k5_entry = None
    s64, c64 = bouncing_spheres_64(dev)
    for name, scene9, cfg9 in (("bouncing_spheres_64", s64, c64),
                               ("bouncing_spheres (walk forced)", scene, cfg)):
        mega9 = build_mega_scene(scene9)
        r9 = Renderer(cfg9, max_rays_per_launch=1 << 18)
        _, (ray_f, ray_i) = first_launch(scene9, cfg9, r9.n_block, r9.spp_chunk, dev)
        B9 = ray_f.shape[1]
        kw9 = dict(max_depth=cfg9.max_depth, background=cfg9.background)
        out = mg.trace_group(mega9, ray_f, ray_i, SEED, 0, use_bvh=True, **kw9)
        k5_ms = cuda_ms(torch, lambda: mg.trace_group(mega9, ray_f, ray_i, SEED, 0,
                                                      use_bvh=True, **kw9), 5)
        ref, plain9_ms = timed(torch, lambda: mg.trace_group_torch(
            mega9, ray_f, ray_i, SEED, 0, use_bvh=True, want_counts=True, **kw9))
        k1 = mb.trace_block(mega9, ray_f, ray_i, SEED, 0, cull=True, **kw9)
        k1_ms = cuda_ms(torch, lambda: mb.trace_block(mega9, ray_f, ray_i, SEED, 0, cull=True,
                                                      **kw9), 3)
        k1_sweep = mb.trace_block(mega9, ray_f, ray_i, SEED, 0, cull=False, **kw9)
        k1_sweep_ms = cuda_ms(torch, lambda: mb.trace_block(mega9, ray_f, ray_i, SEED, 0,
                                                            cull=False, **kw9), 3)
        walk_eq = bit_equal(torch, k1, k1_sweep)
        del k1_sweep
        seg5, seg_p, seg1 = int(out[1].sum()), int(ref[1].sum()), int(k1[1].sum())
        d_p = (out[0] - ref[0]).abs()
        ok9 = equal_outputs(out, ref[:3])
        d_1 = (out[0] - k1[0]).abs()
        m5, m1 = out[0].mean(1), k1[0].mean(1)
        rel = float(((m5 - m1).abs() / m1.abs()).max())
        ok9 &= segments_close(seg1, seg5) and rel < 0.01 and walk_eq
        if k5_entry is not None:  # the bench case: phase 4's launch
            ok9 &= B9 == B
        visits, sph_tests, quad_tests = (int(x) for x in ref[3].sum(1))
        # K5's probe on the same launch: the baseline design against K5's, in
        # turns, and the counting instantiation of each (lanes a warp keeps busy)
        probe9 = {}
        for design in ("baseline", mg.K5_DESIGN, mg.K5_DESIGN, "baseline"):
            def run_probe(design=design, count=False):
                return mg.trace_group_probe(mega9, ray_f, ray_i, SEED, 0, design=design,
                                            count=count, **kw9)

            rp = probe9.setdefault(design, dict(ms=[]))
            rp["ms"].append(cuda_ms(torch, run_probe, 5))
            if "lanes" not in rp:
                po, pc = run_probe(), run_probe(count=True)
                rp["bit_equal"] = all(equal_outputs(x[:3], ref[:3]) for x in (po, pc))
                c = pc[3]
                rp["lanes"] = dict(box=c["box_lanes"] / (32 * c["box_issues"]),
                                   member=c["member_lanes"] / (32 * c["member_issues"]))
                rp["tests"] = (c["visits"], c["sphere_tests"], c["quad_tests"])
        ok9 &= all(v["bit_equal"] for v in probe9.values())
        ok9 &= probe9[mg.K5_DESIGN]["tests"] == (visits, sph_tests, quad_tests)
        ops = (visits * K5_OPS_PER_NODE + sph_tests * K5_OPS_PER_SPHERE_MEMBER
               + quad_tests * K5_OPS_PER_QUAD_MEMBER + seg5 * K5_OPS_SHADE)
        tables = (mega9.table, mega9.nodes, mega9.sph_leaf, mega9.sph_gid, mega9.quad_leaf,
                  mega9.quad_gid)
        b9 = bound(ops, B9 * (mb.N_F * 4 + 8) + B9 * (mb.N_F * 4 + 12 + 4)
                   + 4 * sum(x.numel() for x in tables))
        print(f"phase 9 {name} B={B9} depth {cfg9.max_depth} auto layout {select_layout(mega9)}: "
              f"{'ok' if ok9 else 'FAIL'} K5 vs plain max_abs_err {float(d_p.max()):.3g} mean "
              f"{float(d_p.mean()):.3g} bit_equal {equal_outputs(out, ref[:3])} segments {seg5} "
              f"plain {seg_p}; K5 vs K1 segments {seg5} / {seg1}, launch-mean radiance "
              f"{[round(float(x), 5) for x in m5]} / {[round(float(x), 5) for x in m1]} "
              f"(max rel {rel:.3g}), per-ray mean_abs_err {float(d_1.mean()):.3g}, rays "
              f"differing {float((d_1.max(0).values > 1e-5).float().mean()):.4f}; "
              f"K5 {k5_ms:.3f} ms plain {plain9_ms:.3f} ms K1 walk {k1_ms:.3f} ms sweep "
              f"{k1_sweep_ms:.3f} ms (bit-equal {walk_eq}); node visits "
              f"{visits} ({visits / max(seg5, 1):.1f} per segment) sphere member tests "
              f"{sph_tests} quad member tests {quad_tests}; bound {b9[0]:.4f} ms ({b9[1]}) "
              f"[{card}]")
        print(f"phase 9 {name} K5 probe: " + "; ".join(
            f"{d} design {' '.join(f'{x:.3f}' for x in v['ms'])} ms, bit_equal {v['bit_equal']}, "
            f"active lanes {v['lanes']['box']:.3f} of a warp at a box test, "
            f"{v['lanes']['member']:.3f} at a member test" for d, v in probe9.items())
            + f" [{card}]")
        if not ok9:
            failures.append(f"phase 9 {name}")
        if k5_entry is None:
            k5_entry = dict(max_abs_err=float(d_p.max()), ms=k5_ms, plain_ms=plain9_ms,
                            bound_ms=b9[0], bound_by=b9[1],
                            ms_probe_baseline=sum(probe9["baseline"]["ms"]) / 2,
                            ms_in_turns={d: v["ms"] for d, v in probe9.items()},
                            lane_share={d: v["lanes"] for d, v in probe9.items()})
            k1_64 = dict(ms_walk=k1_ms, ms_sweep=k1_sweep_ms)
        else:  # phase 4's launch: K1's walk bound, its operations from K5's plain walk
            k1_walk_bound = b9
        del ref

    # sqrt_rn (K5's plain version's roots): the float32 route on the card
    # against the float64 route, which is correctly rounded, bit for bit,
    # forward and backward (float32 torch.sqrt's own backward for contrast)
    xs = sqrt_inputs(dev)
    ref_sq = torch.sqrt(xs.double()).float()
    n_f32 = int((torch.sqrt(xs) != ref_sq).sum())
    n_rn = int((sqrt_rn(xs) != ref_sq).sum())
    g_sq = torch.randn(xs.shape, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    ref_g = sqrt_grads(lambda x: torch.sqrt(x.double()).float(), xs, g_sq)
    n_bwd_f32 = int((sqrt_grads(torch.sqrt, xs, g_sq) != ref_g).sum())
    n_bwd_rn = int((sqrt_grads(sqrt_rn, xs, g_sq) != ref_g).sum())
    print(f"phase 9 sqrt_rn: {'ok' if n_rn == n_bwd_rn == 0 else 'FAIL'} of {xs.numel()} "
          f"float32 inputs the card's float32 sqrt differs from the float64 route on {n_f32}, "
          f"sqrt_rn on {n_rn}; backward: float32 sqrt's on {n_bwd_f32}, sqrt_rn's on "
          f"{n_bwd_rn}")
    if n_rn or n_bwd_rn:
        failures.append("phase 9 sqrt_rn")
    del xs, ref_sq, g_sq, ref_g

    # ---- phase 10: the bouncing_spheres_64 render through Renderer ----
    r10 = Renderer(c64, max_rays_per_launch=1 << 18, transfer="u8",
                   phase_depths=[2, 2, 3, 4, c64.max_depth - 11])
    r10.render(s64, seed=SEED)  # warm-up
    zero_counts()
    res10 = r10.render(s64, seed=SEED)
    k5_counts = counts()
    img10 = res10.u8
    ok10 = (k5_counts == only(K5=5 * res10.launches) and res10.segments > 0
            and img10.shape == (c64.image_height, c64.image_width, 3)
            and 20 < float(img10.mean()) < 235)
    print(f"phase 10 bouncing_spheres_64 render: {'ok' if ok10 else 'FAIL'} segments "
          f"{res10.segments} launches {res10.launches} kernel launches {k5_counts} seconds "
          f"{res10.seconds:.4f} {res10.segments / res10.seconds:.4g} rays/s image mean "
          f"{float(img10.mean()):.2f} [{card}]")
    if not ok10:
        failures.append("phase 10 bouncing_spheres_64 render")

    # ---- phase 11: K4 and the fold against their plain versions ----
    # one bounce's K1-recorded winners of the phase-5 chunk (misses are -1),
    # and numpy-seeded ids over the bouncing_spheres_64 replay table; the
    # lookup's backward on a seeded cotangent: the fold (the port's), and
    # index_add_ (its plain version) and the one-hot matmul (the JAX
    # package's) as references, each against a float64 sum
    table64 = rf.build_replay_table(s64).detach()
    ids64 = torch.from_numpy(np.random.default_rng(5).integers(
        -1, table64.shape[0], n_full).astype(np.int32)).to(dev)
    k4_rows, fold_rows = [], []
    for name, tab, idv in (("bench chunk bounce 1", table, ids[1].contiguous()),
                           ("bouncing_spheres_64 table", table64, ids64)):
        L, F = tab.shape
        out = tg.gather(tab, idv)
        torch.cuda.synchronize()
        ref = tg.gather_torch(tab, idv)
        k4_eq = bool(torch.equal(out, ref))
        k4_ms = device_ms(torch, lambda: tg.gather(tab, idv), 20)
        sel_ms = device_ms(torch, lambda: tg.gather_torch(tab, idv), 20)
        g_out = torch.randn((F, n_full), device=dev, generator=torch.Generator(dev).manual_seed(4))
        idc = idv.clamp(0, L - 1).long()

        def lookup_index_add():
            return torch.zeros((L, F), dtype=torch.float32, device=dev).index_add_(0, idc, g_out.t())

        def lookup_onehot():
            return (torch.arange(L, device=dev)[:, None] == idc[None, :]).float() @ g_out.t()

        before = int(tg.fold_launches)
        tbar = tg.fold(g_out, idv, L)
        torch.cuda.synchronize()
        exact = torch.zeros((L, F), dtype=torch.float64, device=dev).index_add_(
            0, idc, g_out.t().double())
        fold_bar = dict(rtol=1e-5, atol=2e-6 * max(1, n_full // L))
        fold_ok = (int(tg.fold_launches) == before + 1
                   and bool(torch.allclose(tbar.double(), exact, **fold_bar)))
        errs = {k: float((v.double() - exact).abs().max()) for k, v in
                (("fold", tbar), ("index_add_", lookup_index_add()), ("onehot", lookup_onehot()))}
        fold_ms = device_ms(torch, lambda: tg.fold(g_out, idv, L), 20)
        add_ms = device_ms(torch, lookup_index_add, 10)
        oh_ms = device_ms(torch, lookup_onehot, 3)
        k4_bound = bound(0, 4 * (idv.numel() + tab.numel() + out.numel()))
        fold_bound = bound(g_out.numel(), 4 * (idv.numel() + g_out.numel() + tab.numel()))
        row = dict(name=name, L=L, F=F, B=n_full, bit_equal=k4_eq,
                   max_abs_err=float((out - ref).abs().max()), ms=k4_ms, plain_ms=sel_ms,
                   library_ms=sel_ms, bound_ms=k4_bound[0], bound_by=k4_bound[1],
                   misses=int((idv < 0).sum()))
        frow = dict(name=name, L=L, F=F, B=n_full, max_abs_err=errs["fold"], ms=fold_ms,
                    plain_ms=add_ms, library_ms=add_ms, onehot_ms=oh_ms, bound_ms=fold_bound[0],
                    bound_by=fold_bound[1], index_add_max_abs_err=errs["index_add_"],
                    onehot_max_abs_err=errs["onehot"], atol=fold_bar["atol"])
        k4_rows.append(row)
        fold_rows.append(frow)
        print(f"phase 11 K4 {name}: {'ok' if k4_eq else 'FAIL'} {json.dumps(row)} [{card}]")
        print(f"phase 11 fold {name}: {'ok' if fold_ok else 'FAIL'} {json.dumps(frow)} [{card}]")
        if not k4_eq:
            failures.append(f"phase 11 K4 {name}")
        if not fold_ok:
            failures.append(f"phase 11 fold {name}")
        del exact, g_out
    del table64, ids64

    # ---- phase 12: replay_trace_fast at full width, gradients to scene and camera ----
    from raytracing_tpu_torch.diff.replay_fast import replay_trace_fast

    spp_chunk, n_pix = 4, cfg.n_pixels
    npix_pad = -(-n_pix // 1024) * 1024
    n_chunks12 = cfg.samples_per_pixel // spp_chunk
    pix12 = torch.clamp(torch.arange(npix_pad, device=dev), max=n_pix - 1).repeat(
        spp_chunk).to(torch.int32)
    act12 = (torch.arange(npix_pad, device=dev) < n_pix).repeat(spp_chunk)
    mega12 = build_mega_scene(scene)
    target12 = torch.from_numpy(np.random.default_rng(11).random((n_pix, 3)).astype(
        np.float32)).to(dev)
    center12 = scene.spheres.center.clone().requires_grad_(True)
    rgb12 = scene.textures.rgb.clone().requires_grad_(True)
    lookfrom12 = torch.tensor(cfg.lookfrom, dtype=torch.float32, device=dev, requires_grad=True)
    scene12 = dataclasses.replace(
        scene, spheres=dataclasses.replace(scene.spheres, center=center12),
        textures=dataclasses.replace(scene.textures, rgb=rgb12))
    params12 = dataclasses.replace(cam.CameraParams.from_config(cfg, dev), lookfrom=lookfrom12)

    def chunk_loss(rad):
        img = (rad * act12[:, None]).reshape(spp_chunk, npix_pad, 3).mean(0)[:n_pix]
        return ((img - target12) ** 2).mean()

    def chunk12(c):
        """One chunk of the sweep: camera rays with autograd to lookfrom,
        K1 decisions, replay_trace_fast and the chunk's MSE."""
        smp = (c * spp_chunk + torch.arange(spp_chunk, device=dev).repeat_interleave(
            npix_pad)).to(torch.int32)
        o, d, t = cam.generate_rays(cfg, cam.derive(cfg, params12), pix12, smp, SEED,
                                    motion_blur=scene.flags.has_moving)
        with torch.no_grad():
            _, _, ids_c = trace_megakernel(mega12, o, d, t, pix12, smp, cfg.background,
                                           cfg.max_depth, SEED, phase_depths=kw["phase_depths"],
                                           active0=act12, want_ids=True)
        rad, seg = replay_trace_fast(scene12, ids_c, o, d, t, pix12, smp, cfg.background,
                                     cfg.max_depth, SEED, remat=False, active0=act12)
        return chunk_loss(rad), rad, seg, ids_c, (o, d, t, smp)

    zero_counts()
    loss0, rad0, seg0, ids0, (o0, d0, t0_, smp0) = chunk12(0)
    torch.cuda.synchronize()
    first_counts = counts()
    (g_rgb_fast,) = torch.autograd.grad(loss0, rgb12, retain_graph=True)
    rad_k, seg_k = rk.replay_trace_kernel(scene12, ids0, o0.detach(), d0.detach(), t0_.detach(),
                                          pix12, smp0, cfg.background, cfg.max_depth, SEED,
                                          active0=act12)
    (g_rgb_k,) = torch.autograd.grad(chunk_loss(rad_k), rgb12)
    loss0.backward()
    torch.cuda.synchronize()
    d12 = (rad0.detach() - rad_k.detach()).abs()
    rel12 = float((g_rgb_fast - g_rgb_k).norm() / g_rgb_k.norm())

    def grads_of(*ps):
        """Each parameter's gradient; zeros where the loss does not reach it
        (the bench scene is flat-shaded: with the decisions fixed its radiance
        does not depend on geometry or camera)."""
        return [torch.zeros_like(x) if x.grad is None else x.grad for x in ps]

    grads12 = grads_of(center12, rgb12, lookfrom12)
    ok12 = (first_counts["K4"] == cfg.max_depth and first_counts["K1"] == 5
            and seg0 == int(seg_k) and float(d12.max()) <= 1e-4 and rel12 < 1e-4
            and all(bool(torch.isfinite(g).all()) for g in grads12)
            and float(grads12[1].abs().sum()) > 0)
    print(f"phase 12 first chunk B={pix12.shape[0]}: {'ok' if ok12 else 'FAIL'} "
          f"segments {seg0} (K3 {int(seg_k)}) radiance bit_equal "
          f"{bool(torch.equal(rad0.detach(), rad_k.detach()))} max_abs_err {float(d12.max()):.3g} "
          f"(bar 1e-4) rgb grad relative L2 vs K2 {rel12:.3g} (bar 1e-4) lookfrom grad "
          f"{[round(float(x), 6) for x in grads12[2]]} center grad max "
          f"{float(grads12[0].abs().max()):.3g} kernel launches {first_counts}")
    if not ok12:
        failures.append("phase 12 first chunk")

    for p_ in (center12, rgb12, lookfrom12):
        p_.grad = None
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    seg12 = 0
    for c in range(n_chunks12):
        loss_c, _, seg_c, _, _ = chunk12(c)
        loss_c.backward()
        seg12 += seg_c
    torch.cuda.synchronize()
    sweep12_s = time.perf_counter() - t0
    sweep12_counts = counts()
    ok12s = (sweep12_counts == only(K1=5 * n_chunks12, K4=cfg.max_depth * n_chunks12,
                                    fold=cfg.max_depth * n_chunks12)
             and segments_close(fb["segments"], seg12)
             and all(bool(torch.isfinite(g).all()) for g in grads_of(center12, rgb12,
                                                                      lookfrom12)))
    print(f"phase 12 replay_trace_fast sweep ({n_chunks12} chunks of {pix12.shape[0]} rays, "
          f"depth {cfg.max_depth}): {'ok' if ok12s else 'FAIL'} wall {sweep12_s:.4f} s segments "
          f"{seg12} (fwd+bwd bench {fb['segments']}) {seg12 / sweep12_s:.4g} segments/s kernel "
          f"launches {sweep12_counts} [{card}]")
    if not ok12s:
        failures.append("phase 12 sweep")
    del rad0, rad_k, ids0, o0, d0, t0_, loss0

    # ---- phase 13: render_once (the wavefront integrator) and camera_grad ----
    from raytracing_tpu_torch.diff import gradients as pgrad
    from raytracing_tpu_torch.diff.replay import render_replay

    cfg13 = dataclasses.replace(cfg, samples_per_pixel=1)
    rgb13 = scene.textures.rgb.clone().requires_grad_(True)
    lookfrom13 = torch.tensor(cfg.lookfrom, dtype=torch.float32, device=dev, requires_grad=True)
    params13 = dataclasses.replace(cam.CameraParams.from_config(cfg13, dev), lookfrom=lookfrom13)
    scene13 = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, rgb=rgb13))
    # the first fwd+bwd pays seconds of one-time CUDA set-up: time the second
    ((pgrad.render_once(scene13, cfg13, params13, seed=SEED) - target12.reshape(
        cfg.image_height, cfg.image_width, 3)) ** 2).mean().backward()
    rgb13.grad = lookfrom13.grad = None
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img13, seg13 = pgrad.render_once(scene13, cfg13, params13, seed=SEED, return_segments=True)
    torch.cuda.synchronize()
    fwd13_s = time.perf_counter() - t0
    ((img13 - target12.reshape(img13.shape)) ** 2).mean().backward()
    torch.cuda.synchronize()
    wall13_s = time.perf_counter() - t0
    peak13 = torch.cuda.max_memory_allocated() / 2 ** 30
    pix13 = torch.clamp(torch.arange(npix_pad, device=dev), max=n_pix - 1).to(torch.int32)
    smp13 = torch.zeros_like(pix13)
    o13, d13, t13 = cam.generate_rays(cfg13, cam.derive(cfg13, cam.CameraParams.from_config(
        cfg13, dev)), pix13, smp13, SEED, motion_blur=scene.flags.has_moving)
    _, seg13_k = trace_megakernel(mega12, o13, d13, t13, pix13, smp13, cfg.background,
                                  cfg.max_depth, SEED, active0=torch.arange(npix_pad, device=dev)
                                  < n_pix)
    ok13 = (segments_close(int(seg13_k), seg13)
            and all(bool(torch.isfinite(g).all()) for g in grads_of(rgb13, lookfrom13))
            and float(grads_of(rgb13)[0].abs().sum()) > 0 and img13.shape == (
                cfg.image_height, cfg.image_width, 3))
    print(f"phase 13 render_once {cfg.image_width}x{cfg.image_height} spp 1 depth {cfg.max_depth}: "
          f"{'ok' if ok13 else 'FAIL'} forward {fwd13_s:.3f} s forward+backward {wall13_s:.3f} s "
          f"segments {seg13} (K1 {int(seg13_k)}) {seg13 / wall13_s:.4g} segments/s fwd+bwd, peak "
          f"memory {peak13:.2f} GiB [{card}]")
    if not ok13:
        failures.append("phase 13 render_once")

    sp13, cp13 = build("perlin_sphere", device=dev, image_width=10, samples_per_pixel=2,
                       max_depth=3)
    p13 = cam.CameraParams.from_config(cp13, dev)
    tgt13 = torch.zeros((cp13.image_height, cp13.image_width, 3), device=dev)
    g_once = pgrad.camera_grad(sp13, tgt13, cp13, p13, seed=4).lookfrom
    lf13 = p13.lookfrom.clone().requires_grad_(True)
    img_rep = render_replay(sp13, cp13, dataclasses.replace(p13, lookfrom=lf13), seed=4)
    (g_rep,) = torch.autograd.grad(((img_rep - tgt13) ** 2).mean(), lf13)
    ok13c = (bool(torch.isfinite(g_once).all()) and float(g_once.abs().sum()) > 0
             and bool(torch.allclose(g_once, g_rep, rtol=0.04, atol=3e-3)))
    print(f"phase 13 camera_grad perlin_sphere: {'ok' if ok13c else 'FAIL'} render_once "
          f"{[round(float(x), 6) for x in g_once]} render_replay "
          f"{[round(float(x), 6) for x in g_rep]} (rtol 0.04, atol 3e-3)")
    if not ok13c:
        failures.append("phase 13 camera_grad")

    # ---- phase 14: fit_albedo ----
    from raytracing_tpu_torch.diff.optimize import fit_albedo

    s14, c14 = build("single_sphere", device=dev, image_width=16, samples_per_pixel=2,
                     max_depth=3)
    tgt14 = pgrad.render_once(s14, c14, seed=0).detach()
    bad14 = dataclasses.replace(s14, textures=dataclasses.replace(
        s14.textures, rgb=s14.textures.rgb * 0.3))
    t0 = time.perf_counter()
    _, losses14 = fit_albedo(bad14, tgt14, c14, steps=60, lr=5e-2, seed=0,
                             reseed_every_step=False)
    ok14 = bool(torch.isfinite(losses14).all()) and float(losses14[-1]) < 0.1 * float(losses14[0])
    print(f"phase 14 fit_albedo single_sphere 60 steps: {'ok' if ok14 else 'FAIL'} loss "
          f"{float(losses14[0]):.4g} -> {float(losses14[-1]):.4g} in "
          f"{time.perf_counter() - t0:.2f} s")
    if not ok14:
        failures.append("phase 14 fit_albedo")

    # ---- phase 15: K1 (marble, image) against its plain version, small launches ----
    from raytracing_tpu_torch.scene import flatten as fl

    tex_scenes = ("perlin_sphere", "simple_light", "earth")
    for name in tex_scenes:
        scene_t, cfg_t = build(name, device=dev, image_width=32, samples_per_pixel=2,
                               max_depth=6)
        mega_t = build_mega_scene(scene_t)
        n_block = -(-cfg_t.n_pixels // 1024) * 1024
        _, (ray_f, ray_i) = first_launch(scene_t, cfg_t, n_block, 2, dev)
        kw15 = dict(max_depth=6, background=cfg_t.background, want_ids=True)
        ref = mb.trace_block_torch(mega_t, ray_f, ray_i, SEED, 3, **kw15)
        both15 = both_searches(torch, mb, (mega_t, ray_f, ray_i, SEED, 3), kw15, ref)
        out = both15["sweep"]["out"]
        image = name == "earth"
        ok15, st15 = compare(torch, mb, image, ref, out, ray_f.shape[1])
        if image:
            # exact, except a ray whose texel index sits on a truncation
            # boundary: those are counted, and every disagreeing ray is one
            edge = texel_boundary(torch, mb, fl, mega_t, ray_f)
            differs = (out[0] - ref[0]).abs().max(0).values > 0
            st15.update(boundary_rays=int(edge.sum()), rays_differing=int(differs.sum()),
                        differing_off_boundary=int((differs & ~edge).sum()))
            ok15 = (segments_close(st15["segments_plain"], st15["segments"])
                    and st15["ids_differing"] == 0 and st15["differing_off_boundary"] == 0)
        else:
            ok15 &= st15["mean_abs_err"] < 1e-3
        ok15 &= all(v["bit_equal"] for v in both15.values())
        st15["marble_shades"], st15["image_shades"] = texture_shades(torch, fl, mega_t, ref[3])
        print(f"phase 15 K1 {name} B={ray_f.shape[1]}: {'ok' if ok15 else 'FAIL'} "
              f"{json.dumps(st15)} {searches_line(both15)}")
        if not ok15:
            failures.append(f"phase 15 K1 {name}")

        # ---- phase 16: K5 on the same launch, against its plain version and K1 ----
        ok16 = True
        outs16 = {}
        for use_bvh in (True, False):
            kw16 = dict(max_depth=6, background=cfg_t.background, use_bvh=use_bvh)
            o5 = mg.trace_group(mega_t, ray_f, ray_i, SEED, 3, **kw16)
            torch.cuda.synchronize()
            r5 = mg.trace_group_torch(mega_t, ray_f, ray_i, SEED, 3, **kw16)
            ok16 &= equal_outputs(o5, r5)
            outs16[use_bvh] = o5
        d51 = (outs16[True][0] - out[0]).abs()
        ok16 &= (equal_outputs(outs16[True], outs16[False])
                 and float(d51.mean()) < 1e-3
                 and segments_close(int(out[1].sum()), int(outs16[True][1].sum())))
        print(f"phase 16 K5 {name}: {'ok' if ok16 else 'FAIL'} walk and sweep bit-equal to "
              f"plain and to each other; vs K1 mean_abs_err {float(d51.mean()):.3g} max "
              f"{float(d51.max()):.3g} segments {int(outs16[True][1].sum())} / "
              f"{int(out[1].sum())}")
        if not ok16:
            failures.append(f"phase 16 K5 {name}")

    # ---- phase 17: K1's depth cap against its plain version, pool-shaped launches ----
    for name, exact in (("bouncing_spheres", False), ("perlin_sphere", False),
                        ("earth", True)):
        scene_c, cfg_c = build(name, device=dev, image_width=64, samples_per_pixel=2,
                               max_depth=8)
        mega_c = build_mega_scene(scene_c)
        n_block = -(-cfg_c.n_pixels // 1024) * 1024
        _, (ray_f, ray_i) = first_launch(scene_c, cfg_c, n_block, 2, dev)
        dep = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg_c.max_depth, ray_f.shape[1]).astype(np.int32)).to(dev)
        kw17 = dict(max_depth=2, background=cfg_c.background, depth_cap=cfg_c.max_depth,
                    dep=dep)
        ref = mb.trace_block_torch(mega_c, ray_f, ray_i, SEED, 0, **kw17)
        both17 = both_searches(torch, mb, (mega_c, ray_f, ray_i, SEED, 0), kw17, ref)
        out = both17["walk"]["out"]
        ok17, st17 = compare(torch, mb, exact, ref, out, ray_f.shape[1])
        ok17 &= all(v["bit_equal"] for v in both17.values())
        capped = int(((dep + out[1] == cfg_c.max_depth) & (out[1] > 0)).sum())
        ok17 &= bool((dep + out[1] <= cfg_c.max_depth).all()) and capped > 0
        print(f"phase 17 K1 depth cap {name} B={ray_f.shape[1]} cap {cfg_c.max_depth}: "
              f"{'ok' if ok17 else 'FAIL'} {json.dumps(st17)} rays ending at the cap {capped} "
              f"{searches_line(both17)}")
        if not ok17:
            failures.append(f"phase 17 depth cap {name}")

    # ---- phase 18: one full-width launch of the textured scenes, K1 and K5 ----
    tex_rows = {}
    for name in ("perlin_sphere", "earth"):
        scene_f, cfg_f = build(name, device=dev)
        mega_f = build_mega_scene(scene_f)
        r18 = Renderer(cfg_f, max_rays_per_launch=1 << 18)
        _, (ray_f, ray_i) = first_launch(scene_f, cfg_f, r18.n_block, r18.spp_chunk, dev)
        B18 = ray_f.shape[1]
        kw18 = dict(max_depth=cfg_f.max_depth, background=cfg_f.background)
        with texels_read(mb) as read18:
            ref, k1_plain_ms18 = timed(torch, lambda: mb.trace_block_torch(
                mega_f, ray_f, ray_i, SEED, 0, want_ids=True, **kw18))
        both18 = both_searches(torch, mb, (mega_f, ray_f, ray_i, SEED, 0),
                               dict(kw18, want_ids=True), ref)
        out = both18["sweep"]["out"]
        k1_ms18 = both18["walk" if mb.walks(mega_f) else "sweep"]["ms"]
        image = name == "earth"
        ok18, st18 = compare(torch, mb, image, ref, out, B18)
        if image:  # as in phase 15
            edge = texel_boundary(torch, mb, fl, mega_f, ray_f)
            differs = (out[0] - ref[0]).abs().max(0).values > 0
            st18.update(boundary_rays=int(edge.sum()), rays_differing=int(differs.sum()),
                        differing_off_boundary=int((differs & ~edge).sum()))
            ok18 = (segments_close(st18["segments_plain"], st18["segments"])
                    and st18["ids_differing"] == 0 and st18["differing_off_boundary"] == 0)
        else:
            ok18 &= st18["mean_abs_err"] < 1e-3
        n_marble, n_image = texture_shades(torch, fl, mega_f, ref[3])
        seg18 = st18["segments"]
        tex_ops = n_marble * K1_OPS_MARBLE + n_image * K1_OPS_IMAGE
        # the texture tables count as far as this launch reads them: the
        # Perlin tables whole once a marble shade runs, and of the atlas the
        # distinct texels the plain version fetched (12 B each)
        n_texels = int(torch.unique(torch.cat(read18)).numel()) if read18 else 0
        tables18 = 4 * (8 * mega_f.n_sph + 16 * mega_f.n_quad
                        + mega_f.table.numel() + mega_f.kid_map.numel()
                        + (mega_f.perm.numel() + mega_f.grad.numel() if n_marble else 0)
                        + 3 * n_texels)
        b18 = bound(seg18 * (K1_OPS_PER_SPHERE_ROW * mega_f.n_sph + K1_OPS_PER_QUAD_ROW
                             * mega_f.n_quad + K1_OPS_SHADE) + tex_ops,
                    B18 * (mb.N_F * 4 * 2 + 8 + 12 + 4) + tables18)
        o5 = mg.trace_group(mega_f, ray_f, ray_i, SEED, 0, use_bvh=True, **kw18)
        k5_ms18 = cuda_ms(torch, lambda: mg.trace_group(mega_f, ray_f, ray_i, SEED, 0,
                                                        use_bvh=True, **kw18), 5)
        r5, k5_plain_ms18 = timed(torch, lambda: mg.trace_group_torch(
            mega_f, ray_f, ray_i, SEED, 0, use_bvh=True, want_counts=True, **kw18))
        ok18 &= equal_outputs(o5, r5[:3]) and all(v["bit_equal"] for v in both18.values())
        visits, sph_tests, quad_tests = (int(x) for x in r5[3].sum(1))
        seg5 = int(o5[1].sum())
        b5 = bound(visits * K5_OPS_PER_NODE + sph_tests * K5_OPS_PER_SPHERE_MEMBER
                   + quad_tests * K5_OPS_PER_QUAD_MEMBER + seg5 * K5_OPS_SHADE + tex_ops,
                   B18 * (mb.N_F * 4 + 8) + B18 * (mb.N_F * 4 + 12 + 4) + tables18)
        tex_rows[name] = dict(
            k1=dict(max_abs_err=st18["max_abs_err"], ms=k1_ms18, plain_ms=k1_plain_ms18,
                    bound_ms=b18[0], bound_by=b18[1]),
            k5=dict(max_abs_err=float((o5[0] - r5[0]).abs().max()), ms=k5_ms18,
                    plain_ms=k5_plain_ms18, bound_ms=b5[0], bound_by=b5[1]))
        print(f"phase 18 full-width launch {name} B={B18} depth {cfg_f.max_depth}: "
              f"{'ok' if ok18 else 'FAIL'} {json.dumps(st18)} marble shades {n_marble} image "
              f"shades {n_image} distinct texels {n_texels}; K1 {searches_line(both18)} plain "
              f"{k1_plain_ms18:.3f} ms bound {b18[0]:.4f} ms ({b18[1]}); K5 walk {k5_ms18:.3f} "
              f"ms plain {k5_plain_ms18:.3f} ms bound {b5[0]:.4f} ms ({b5[1]}), bit_equal to plain "
              f"{equal_outputs(o5, r5[:3])}, segments {seg5} [{card}]")
        if not ok18:
            failures.append(f"phase 18 {name}")
        del ref, r5, both18

    # ---- phase 19: the bench workload through the pool schedule ----
    rp = Renderer(cfg, max_rays_per_launch=1 << 18, transfer="u8", schedule="pool")
    rp.render(scene, seed=SEED)  # warm-up
    zero_counts()
    resp = rp.render(scene, seed=SEED)
    pool_counts = counts()
    # the two schedules in turns: phased, pool, pool, phased
    turns = [("phased", r), ("pool", rp), ("pool", rp), ("phased", r)]
    times19 = {"phased": [], "pool": []}
    for label, rr in turns:
        x = rr.render(scene, seed=SEED)
        times19[label].append(round(x.seconds, 4))
        if x.segments != (res.segments if label == "phased" else resp.segments):
            failures.append(f"phase 19 {label} segments vary")
    du8 = np.abs(resp.u8.astype(np.int16) - res.u8.astype(np.int16))
    ok19 = (resp.segments == res.segments == PORT_BENCH_SEGMENTS and resp.launches == 1
            and pool_counts["K1"] > 0
            and pool_counts == only(K1=pool_counts["K1"])
            and int(du8.max()) <= 1 and float((du8 > 0).mean()) < 0.01)
    print(f"phase 19 bench pool render: {'ok' if ok19 else 'FAIL'} segments {resp.segments} "
          f"(phased {res.segments}) K1 launches {pool_counts['K1']} (phased render "
          f"{render_counts['K1']}) u8 vs phased max |d| {int(du8.max())} values differing "
          f"{int((du8 > 0).sum())} of {du8.size} (bar: 1 level on < 1%) seconds pool "
          f"{[round(resp.seconds, 4)] + times19['pool']} phased {times19['phased']} "
          f"{resp.segments / min(times19['pool']):.4g} rays/s pool best [{card}]")
    if not ok19:
        failures.append("phase 19 bench pool render")

    # ---- phase 20: the textured registry scenes through Renderer, both schedules ----
    reg_counts = {}
    for name in tex_scenes:
        scene_r, cfg_r = build(name, device=dev)
        row = {}
        for sched in ("phased", "pool"):
            rr = Renderer(cfg_r, transfer="u8", schedule=sched)
            rr.render(scene_r, seed=SEED)  # warm-up
            zero_counts()
            x = rr.render(scene_r, seed=SEED)
            row[sched] = (x, counts())
        (xa, ca), (xb, cb) = row["phased"], row["pool"]
        d20 = np.abs(xa.u8.astype(np.int16) - xb.u8.astype(np.int16))
        small_kw = dict(image_width=32, samples_per_pixel=2, max_depth=5)
        s_g, c_g = build(name, device=dev, **small_kw)
        s_c, c_c = build(name, device="cpu", **small_kw)
        errs = []
        for sched in ("phased", "pool"):
            g = Renderer(c_g, schedule=sched).render(s_g, seed=SEED)
            c = Renderer(c_c, schedule=sched).render(s_c, seed=SEED)
            errs.append((float(abs(g.radiance - c.radiance).mean()), g.segments, c.segments))
        ok20 = (xa.segments == xb.segments and int(d20.max()) <= 1
                and float((d20 > 0).mean()) < 0.01 and int(xa.u8.max()) > 0
                and ca["K1"] == 3 * xa.launches and cb["K1"] > 0
                and all(e < 1e-3 and segments_close(sc, sg) for e, sg, sc in errs))
        reg_counts[name] = dict(phased=ca["K1"], pool=cb["K1"])
        print(f"phase 20 {name} {cfg_r.image_width}x{cfg_r.image_height} "
              f"{cfg_r.samples_per_pixel} spp depth {cfg_r.max_depth}: "
              f"{'ok' if ok20 else 'FAIL'} segments phased {xa.segments} pool {xb.segments} "
              f"u8 max |d| {int(d20.max())} image mean {float(xa.u8.mean()):.2f} seconds "
              f"phased {xa.seconds:.4f} pool {xb.seconds:.4f} K1 launches phased {ca['K1']} "
              f"pool {cb['K1']}; small card vs cpu (phased, pool) mean_abs_err and segments "
              f"{errs} [{card}]")
        if not ok20:
            failures.append(f"phase 20 {name}")

    # ---- phase 21: render_replay_fast on the marble scene (K1 decisions) ----
    from raytracing_tpu_torch.diff.replay import render_replay_fast

    sp21, cp21 = build("perlin_sphere", device=dev, image_width=64, samples_per_pixel=2,
                       max_depth=5)
    p21 = cam.CameraParams.from_config(cp21, dev)
    tgt21 = torch.zeros((cp21.image_height, cp21.image_width, 3), device=dev)

    def grad21(fn):
        lf = p21.lookfrom.clone().requires_grad_(True)
        img = fn(sp21, cp21, dataclasses.replace(p21, lookfrom=lf), seed=4)
        (g,) = torch.autograd.grad(((img - tgt21) ** 2).mean(), lf)
        return img.detach(), g

    zero_counts()
    img_f, g_f = grad21(render_replay_fast)
    c21 = counts()
    img_r, g_r = grad21(render_replay)
    e21 = float((img_f - img_r).abs().mean())
    ok21 = (c21["K1"] >= 1 and e21 < 1e-3 and float(g_r.abs().sum()) > 0
            and bool(torch.allclose(g_f, g_r, rtol=0.04, atol=3e-3)))
    print(f"phase 21 render_replay_fast perlin_sphere: {'ok' if ok21 else 'FAIL'} image vs "
          f"render_replay mean_abs_err {e21:.3g} camera grad {[round(float(x), 6) for x in g_f]} "
          f"vs {[round(float(x), 6) for x in g_r]} (rtol 0.04, atol 3e-3) kernel launches {c21}")
    if not ok21:
        failures.append("phase 21 render_replay_fast")

    # ---- phase 22: K1's two searches: registry crossover, a large scene, the pool ----
    from raytracing_tpu_torch.models.scenes import SCENES

    crossover = [(name, lambda n=name: build(n, device=dev)) for name in SCENES]
    crossover += [(f"bouncing_spheres {2 * h}x{2 * h} grid",
                   lambda h=h: bouncing_spheres_64(dev, half=h)) for h in (1, 2, 3, 4, 6, 8)]
    for name, make in crossover:
        scene_x, cfg_x = make()
        mega_x = build_mega_scene(scene_x)
        rx = Renderer(cfg_x, max_rays_per_launch=1 << 18)
        _, (ray_f, ray_i) = first_launch(scene_x, cfg_x, rx.n_block, rx.spp_chunk, dev)
        kwx = dict(max_depth=cfg_x.max_depth, background=cfg_x.background)
        ref = mb.trace_block(mega_x, ray_f, ray_i, SEED, 0, cull=False, **kwx)
        bx = both_searches(torch, mb, (mega_x, ray_f, ray_i, SEED, 0), kwx, ref, reps=10)
        okx = bx["walk"]["bit_equal"]
        print(f"phase 22 crossover {name}: {'ok' if okx else 'FAIL'} primitives "
              f"{mega_x.n_sph + mega_x.n_quad} nodes {mega_x.cull_nodes.shape[0]} B="
              f"{ray_f.shape[1]} depth {cfg_x.max_depth} segments {int(ref[1].sum())} "
              f"{searches_line(bx)} (walk against sweep) default "
              f"{'walk' if mb.walks(mega_x) else 'sweep'} [{card}]")
        if not okx:
            failures.append(f"phase 22 crossover {name}")
        del ref, bx

    mega64 = build_mega_scene(s64)
    r64 = Renderer(c64, max_rays_per_launch=1 << 18)
    _, (ray_f, ray_i) = first_launch(s64, c64, r64.n_block, r64.spp_chunk, dev)
    dep = torch.from_numpy(np.random.default_rng(2).integers(
        0, c64.max_depth, ray_f.shape[1]).astype(np.int32)).to(dev)
    kw22 = dict(max_depth=pool_mod.K_BOUNCES, background=c64.background,
                depth_cap=c64.max_depth, dep=dep)
    ref, plain22_ms = timed(torch, lambda: mb.trace_block_torch(mega64, ray_f, ray_i, SEED, 0,
                                                                **kw22))
    both22 = both_searches(torch, mb, (mega64, ray_f, ray_i, SEED, 0), kw22, ref, reps=3)
    ok22 = all(v["bit_equal"] for v in both22.values()) and int(ref[1].sum()) > 0
    k1_pool64 = {k: v["ms"] for k, v in both22.items()}
    print(f"phase 22 bouncing_spheres_64 pool-shaped launch B={ray_f.shape[1]} "
          f"{pool_mod.K_BOUNCES} bounces cap {c64.max_depth}: {'ok' if ok22 else 'FAIL'} "
          f"segments {int(ref[1].sum())} {searches_line(both22)} plain {plain22_ms:.3f} ms "
          f"[{card}]")
    if not ok22:
        failures.append("phase 22 bouncing_spheres_64 pool-shaped launch")
    del ref, both22

    rp64 = {search: Renderer(c64, max_rays_per_launch=1 << 18, transfer="u8", schedule="pool",
                             cull=search == "walk") for search in ("walk", "sweep")}
    pool64 = {}
    # each renderer's first render (its capture, and a warm-up launch) is a warm-up
    for search in ("walk", "sweep", "walk", "sweep", "walk"):
        zero_counts()
        x = rp64[search].render(s64, seed=SEED)
        pool64.setdefault(search, []).append((x, counts()))
    xw, cw = pool64["walk"][1]
    xs, cs = pool64["sweep"][1]
    ok22p = (xw.segments == xs.segments and bool(np.array_equal(xw.u8, xs.u8))
             and cw["K1"] > 0 and cw["K1"] == cs["K1"]
             and cw == only(K1=cw["K1"])
             and 20 < float(xw.u8.mean()) < 235)
    pool64_s = {k: [round(x.seconds, 4) for x, _ in v[1:]] for k, v in pool64.items()}
    print(f"phase 22 bouncing_spheres_64 pool render: {'ok' if ok22p else 'FAIL'} segments "
          f"{xw.segments} (sweep {xs.segments}, phased K5 render {res10.segments}) u8 equal "
          f"{bool(np.array_equal(xw.u8, xs.u8))} K1 launches {cw['K1']} seconds walk "
          f"{pool64_s['walk']} sweep {pool64_s['sweep']} (phased K5 render {res10.seconds:.4f}) "
          f"[{card}]")
    if not ok22p:
        failures.append("phase 22 bouncing_spheres_64 pool render")

    # a scene whose sweep tables exceed the sweep's shared memory: the walk only
    from raytracing_tpu_torch.render.camera import CameraConfig
    from raytracing_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian((0.5, 0.5, 0.5)))
    rng = np.random.default_rng(9)
    mats = [b.lambertian(tuple(rng.random(3))) for _ in range(16)] + [b.metal((0.8, 0.8, 0.8),
                                                                              0.1)]
    for k in range(9000):
        b.sphere((rng.uniform(-48, 48), 0.2, rng.uniform(-48, 48)), 0.2, mats[k % len(mats)])
    big = b.compile(dev)
    cbig = CameraConfig(aspect_ratio=16.0 / 9.0, image_width=64, samples_per_pixel=2,
                        max_depth=6, background=(0.7, 0.8, 1.0), vfov=20.0,
                        lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0))
    mbig = build_mega_scene(big)
    _, (ray_f, ray_i) = first_launch(big, cbig, -(-cbig.n_pixels // 1024) * 1024, 2, dev)
    kwb = dict(max_depth=cbig.max_depth, background=cbig.background, want_ids=True)
    before = int(mb.launches)
    outb = mb.trace_block(mbig, ray_f, ray_i, SEED, 0, **kwb)
    torch.cuda.synchronize()
    refb = mb.trace_block_torch(mbig, ray_f, ray_i, SEED, 0, **kwb)
    try:
        mb.trace_block(mbig, ray_f, ray_i, SEED, 0, cull=False, **kwb)
        refused = False
    except ValueError:
        refused = True
    okb = (mb.walks(mbig) and int(mb.launches) == before + 1 and bit_equal(torch, outb, refb)
           and refused and int(outb[1].sum()) > 0)
    print(f"phase 22 large scene ({mbig.n_sph} spheres, sweep tables "
          f"{4 * (mbig.sph_sweep.numel() + mbig.quad_sweep.numel())} B): "
          f"{'ok' if okb else 'FAIL'} walk bit-equal to plain {bit_equal(torch, outb, refb)}, "
          f"sweep refused {refused}, segments {int(outb[1].sum())}")
    if not okb:
        failures.append("phase 22 large scene")

    # ---- phase 23: a scene the megakernels cannot express, through hit_method="auto" ----
    def bilinear(device):
        b = SceneBuilder()
        img = np.random.default_rng(5).random((6, 9, 3)).astype(np.float32)
        b.sphere((0.0, -100.0, 0.0), 99.5, b.lambertian((0.5, 0.5, 0.5)))
        b.sphere((0.0, 0.3, 0.0), 0.8, b.lambertian(b.image(img)))
        b.sphere((1.6, 0.0, 0.5), 0.5, b.metal((0.8, 0.7, 0.6), 0.1))
        return b.compile(device, image_bilinear=True)

    c23 = CameraConfig(aspect_ratio=1.0, image_width=64, samples_per_pixel=4, max_depth=8,
                       vfov=30.0, lookfrom=(0.0, 1.5, 6.0), lookat=(0.0, 0.3, 0.0),
                       background=(0.7, 0.8, 1.0))
    s23 = bilinear(dev)
    r23 = Renderer(c23)
    zero_counts()
    g23 = r23.render(s23, seed=SEED)
    c23_counts = counts()
    cpu23 = Renderer(c23).render(bilinear("cpu"), seed=SEED)
    e23 = float(np.abs(g23.radiance - cpu23.radiance).mean())
    ok23 = (r23.resolve_hit_method(s23) == "brute" and all(v == 0 for v in c23_counts.values())
            and bool(np.isfinite(g23.radiance).all()) and e23 < 1e-3
            and segments_close(cpu23.segments, g23.segments)
            and 0.05 < float(g23.radiance.mean()) < 1.0)
    print(f"phase 23 bilinear image through hit_method='auto': {'ok' if ok23 else 'FAIL'} path "
          f"{r23.resolve_hit_method(s23)} kernel launches {c23_counts} card vs cpu mean_abs_err "
          f"{e23:.3g} segments {g23.segments} cpu {cpu23.segments} seconds {g23.seconds:.4f} "
          f"[{card}]")
    # more than 64 primitives and a BVH: "auto" takes the integrator's BVH,
    # fused (the walk kernel inside the captured launch)
    from torch_parity import bilinear_grid

    s23b = bilinear_grid(SceneBuilder()).compile(dev, image_bilinear=True)
    r23b = Renderer(c23)
    r23b.render(s23b, seed=SEED)  # captures
    zero_counts()
    g23b = r23b.render(s23b, seed=SEED)
    c23b_counts = counts()
    cpu23b = Renderer(c23).render(bilinear_grid(SceneBuilder()).compile(
        "cpu", image_bilinear=True), seed=SEED)
    e23b = float(np.abs(g23b.radiance - cpu23b.radiance).mean())
    ok = (r23b.resolve_hit_method(s23b) == "bvh" and r23b.programs.program is not None
          and c23b_counts == only(walk=c23.max_depth * g23b.launches)
          and bool(np.isfinite(g23b.radiance).all()) and e23b < 1e-3
          and segments_close(cpu23b.segments, g23b.segments)
          and 0.05 < float(g23b.radiance.mean()) < 1.0)
    print(f"phase 23 bilinear image among 80 spheres ({s23b.n_primitives} primitives) through "
          f"hit_method='auto', fused: {'ok' if ok else 'FAIL'} path "
          f"{r23b.resolve_hit_method(s23b)} kernel launches {c23b_counts} card vs cpu "
          f"mean_abs_err {e23b:.3g} segments {g23b.segments} cpu {cpu23b.segments} seconds "
          f"{g23b.seconds:.4f} [{card}]")
    ok23 &= ok
    if not ok23:
        failures.append("phase 23 hit_method auto")

    # ---- phase 24: the CLI render at the bench configuration ----
    import io
    import tempfile

    from raytracing_tpu_torch import cli
    from raytracing_tpu_torch.utils import checkpoint as ckpt
    from raytracing_tpu_torch.utils.image_io import write_ppm

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    bench_kw = dict(image_width=400, samples_per_pixel=100, max_depth=20)
    scene24, cfg24 = build("bouncing_spheres", device=dev, **bench_kw)
    cli_args = ["render", "--scene", "bouncing_spheres", "--width", "400", "--spp", "100",
                "--depth", "20", "--seed", str(SEED), "--auto-prefix",
                "--out", str(tmp / "cli.ppm"), "--log", str(tmp / "cli.jsonl")]
    shown = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(shown):
        rc24 = cli.main(cli_args)
    cli_wall = time.perf_counter() - t0
    cli_counts = counts()
    with open(tmp / "cli.jsonl") as f:
        done24 = [json.loads(line) for line in f][-1]
    r24 = Renderer(cfg24, phase_depths=kw["phase_depths"], phase_prefixes=pref)
    res24 = r24.render(scene24, seed=SEED)
    write_ppm(str(tmp / "renderer.ppm"), res24.radiance)
    ppm_equal = (tmp / "cli.ppm").read_bytes() == (tmp / "renderer.ppm").read_bytes()
    ok24 = (rc24 == 0 and ppm_equal and done24["event"] == "render_done"
            and done24["segments"] == PORT_BENCH_SEGMENTS == res24.segments
            and done24["hit_method"] == "mega"
            and cli_counts == only(K1=plan_counts["K1"] + render_counts["K1"],
                                   K1_camera=plan_counts["K1_camera"]
                                   + render_counts["K1_camera"])
            and "Done." in shown.getvalue())
    print(f"phase 24 cli render bouncing_spheres 400x225 spp 100 depth 20 --auto-prefix: "
          f"{'ok' if ok24 else 'FAIL'} rc {rc24} PPM byte-equal to Renderer + write_ppm "
          f"{ppm_equal} segments {done24['segments']} kernel launches {cli_counts} (phase 3 "
          f"plan {plan_counts['K1']} + render {render_counts['K1']}) wall {cli_wall:.4f} s "
          f"render {done24['seconds']:.4f} s [{card}]")
    if not ok24:
        failures.append("phase 24 cli render")

    # ---- phase 25: the bench render with a checkpoint every sample chunk, resumed ----
    # the walls without a checkpoint are the launch loop's, which a
    # checkpoint takes; the resumed render is fused (its second render,
    # after the one that captured its graph, is counted)
    r25 = Renderer(cfg24, phase_depths=kw["phase_depths"], phase_prefixes=pref, fused=False)
    n_mid = -(-cfg24.samples_per_pixel // r25.spp_chunk) // 2

    def save_each(st):
        ckpt.save_render_state(str(tmp / "last.npz"), st)
        if st["schunk"] == n_mid:
            ckpt.save_render_state(str(tmp / "mid.npz"), st)

    walls25 = {"none": [], "every chunk": []}
    for turn in ("none", "every chunk", "none", "every chunk"):
        zero_counts()
        x = r25.render(scene24, seed=SEED, checkpoint_cb=save_each if turn != "none" else None)
        walls25[turn].append((x, counts()))
    whole, ck_run = walls25["none"][0][0], walls25["every chunk"][0][0]
    mid = ckpt.load_render_state(str(tmp / "mid.npz"))
    r25f = Renderer(cfg24, phase_depths=kw["phase_depths"], phase_prefixes=pref)
    r25f.render(scene24, seed=SEED, resume_state=mid)
    zero_counts()
    resumed = r25f.render(scene24, seed=SEED, resume_state=mid)
    resumed_counts = counts()
    ok25 = (bool(np.array_equal(resumed.radiance, whole.radiance))
            and bool(np.array_equal(ck_run.radiance, whole.radiance))
            and bool(np.array_equal(whole.radiance, res24.radiance))
            and resumed.segments == ck_run.segments == whole.segments == PORT_BENCH_SEGMENTS
            and mid["schunk"] == n_mid and resumed.launches == whole.launches - n_mid
            and resumed_counts == only(K1=5 * resumed.launches, K1_camera=resumed.launches)
            and all(c == render_counts for _, c in walls25["none"] + walls25["every chunk"]))
    print(f"phase 25 checkpoint every sample chunk and resume at chunk {n_mid}: "
          f"{'ok' if ok25 else 'FAIL'} radiance bit-equal {bool(np.array_equal(resumed.radiance, whole.radiance))} "
          f"segments {resumed.segments} launches {resumed.launches} kernel launches "
          f"{resumed_counts} walls no checkpoint {[round(x.seconds, 4) for x, _ in walls25['none']]} "
          f"checkpoint every chunk {[round(x.seconds, 4) for x, _ in walls25['every chunk']]} "
          f"resumed {resumed.seconds:.4f} s [{card}]")
    if not ok25:
        failures.append("phase 25 checkpoint and resume")

    # ---- phase 26: the integrator's BVH: the walk kernel, fused renders, full width ----
    # tools/time_bvh_walk.py: rt_bvh_walk against the plain walk and brute
    # force on one launch's rays, the cut render fused, looped and brute in
    # turns, then the bench configuration through "bvh", fused
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import time_bvh_walk as tbw
    from raytracing_tpu_torch.diff.gradients import render_once, scene_grad
    from raytracing_tpu_torch.ops.intersect import closest_hit_brute
    from torch_parity import bvh_ray_sets, noise_row, noise_row_config

    s26, c26 = build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=4,
                     max_depth=8)
    ok26 = True
    walk26 = {}
    for name26, rays26 in bvh_ray_sets(s26, c26, SEED).items():
        zero_counts()
        row = walk26[name26] = tbw.walk_row(s26, *rays26)
        row_counts = counts()  # walk() and closest_hit_bvh once each; the timed ones are raw
        ok = (row["bit_equal"] and row["valid_equal"] and row["t_equal_where_same"]
              and row["ties"] <= row["B"] // 1000 and row["hit_launches"] == 1
              and row_counts == only(walk=2))
        print(f"phase 26 rt_bvh_walk {name26} B={row['B']}: {'ok' if ok else 'FAIL'} "
              f"{json.dumps(row)} [{card}]")
        ok26 &= ok
    zero_counts()
    rr26 = tbw.render_rows(s26, c26)
    rows26 = rr26["rows"]
    fused26, loop26, brute26 = rows26["bvh fused"], rows26["bvh loop"], rows26["brute fused"]
    ok = (rr26["fused_equals_loop"] and rr26["mean_abs_err_vs_brute"] < 2e-3
          and segments_close(brute26["segments"], fused26["segments"])
          and fused26["walk_launches"] == loop26["walk_launches"]
          == [c26.max_depth * fused26["launches"]] * 2
          and brute26["walk_launches"] == [0, 0] and bool(np.isfinite(rr26["radiance"]).all()))
    print(f"phase 26 bouncing_spheres 400x225 spp 4 depth 8 bvh fused (no host read after its "
          f"capture) against bvh looped and brute fused, in turns: {'ok' if ok else 'FAIL'} "
          f"mean_abs_err vs brute {rr26['mean_abs_err_vs_brute']:.3g} fused equals loop "
          f"{rr26['fused_equals_loop']} {json.dumps(rows26)} [{card}]")
    ok26 &= ok
    # render_once and scene_grad through the walk kernel against brute force
    s26g, c26g = noise_row(SceneBuilder()).compile(dev), noise_row_config(CameraConfig)
    zero_counts()
    img_bvh = render_once(s26g, c26g, seed=4, hit_fn=traverse.closest_hit_bvh)
    grad_counts = counts()
    img_brute = render_once(s26g, c26g, seed=4, hit_fn=closest_hit_brute)
    target26 = torch.full((c26g.image_height, c26g.image_width, 3), 0.3, device=dev)
    g_bvh = scene_grad(s26g, target26, c26g, seed=4, hit_fn=traverse.closest_hit_bvh)
    g_brute = scene_grad(s26g, target26, c26g, seed=4, hit_fn=closest_hit_brute)
    grad_dev = {}
    grads_ok = True
    for group, field in (("spheres", "center"), ("spheres", "radius"), ("textures", "rgb"),
                         ("quads", "q"), ("materials", "fuzz")):
        a = getattr(getattr(g_bvh, group), field).double()
        b = getattr(getattr(g_brute, group), field).double()
        grad_dev[f"{group}.{field}"] = float((a - b).abs().max())
        grads_ok &= bool(((a - b).abs() <= 1e-9 + 1e-5 * b.abs()).all())
    ok = (bool(torch.equal(img_bvh, img_brute)) and grads_ok
          and grad_counts == only(walk=c26g.max_depth)
          and float(g_brute.spheres.center.abs().sum()) > 0)
    print(f"phase 26 render_once and scene_grad through closest_hit_bvh against brute force: "
          f"{'ok' if ok else 'FAIL'} image bit-equal {bool(torch.equal(img_bvh, img_brute))} "
          f"gradient max |diff| {json.dumps(grad_dev)} kernel launches {grad_counts} [{card}]")
    ok26 &= ok
    # the bench configuration through "bvh", fused: the path's walk launches
    # counted from zero around each timed render
    s26f, c26f = build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=100,
                       max_depth=20)
    full26 = tbw.full_width(s26f, c26f)
    rad26 = full26.pop("radiance")
    e26f = float(np.abs(rad26 - res24.radiance).mean())
    ok = (e26f < 2e-3 and segments_close(PORT_BENCH_SEGMENTS, full26["segments"])
          and full26["walk_launches"] == c26f.max_depth * full26["launches"] > 0
          and bool(np.isfinite(rad26).all()))
    print(f"phase 26 bouncing_spheres 400x225 spp 100 depth 20 hit_method bvh fused: "
          f"{'ok' if ok else 'FAIL'} mean_abs_err vs phase 24's megakernel render {e26f:.3g} "
          f"{json.dumps(full26)} [{card}]")
    ok26 &= ok
    if not ok26:
        failures.append("phase 26 integrator BVH")
    del s26f, rad26

    # ---- phase 27: entry() on the card ----
    from raytracing_tpu_torch.entry import entry

    forward, (scene27, params27) = entry()
    img27 = forward(scene27, params27)  # warm-up
    img27, fwd27_ms = timed(torch, lambda: forward(scene27, params27))
    ok27 = (img27.is_cuda and tuple(img27.shape) == (54, 96, 3)
            and bool(torch.isfinite(img27).all()) and 0.05 < float(img27.mean()) < 1.0)
    print(f"phase 27 entry() forward bouncing_spheres 96x54 spp 2 depth 6: "
          f"{'ok' if ok27 else 'FAIL'} mean {float(img27.mean()):.4f} {fwd27_ms:.3f} ms "
          f"[{card}]")
    if not ok27:
        failures.append("phase 27 entry")
    shutil.rmtree(tmp, ignore_errors=True)

    # ---- phase 28: BASELINE acceptance configs 1-5 at full size ----
    from raytracing_tpu_torch import acceptance

    with open(Path(__file__).resolve().parent / "ACCEPTANCE_r05.json") as f:
        accept_ref = {c["config"]: c for c in json.load(f)["configs"]}
    accept_rows, accept_counts = {}, {}
    for n in (1, 2, 3, 4, 5):
        c = {k: v for k, v in acceptance.CONFIGS[n].items() if k != "differentiable"}
        zero_counts()
        t0 = time.perf_counter()
        row = acceptance.run_config(n, c, seed=SEED, reps=1, device=dev)
        row["wall_s"] = round(time.perf_counter() - t0, 3)
        accept_counts[n] = counts()
        ref = accept_ref[n]
        mean_dev = max(abs(a - b) for a, b in zip(row["mean_u8"], ref["mean_u8"]))
        # config 4's texture is the repository's procedural stand-in for the
        # earth image the reference rendered: its mean is recorded, not held
        ok = (segments_close(ref["segments"], row["segments"])
              and abs(row["nonblack_frac"] - ref["nonblack_frac"]) <= 0.01
              and (n == 4 or mean_dev <= 1.0) and row["hit_method"] == "mega"
              and accept_counts[n] == only(K1=accept_counts[n]["K1"],
                                           K1_camera=accept_counts[n]["K1_camera"])
              and accept_counts[n]["K1"] > 0 and accept_counts[n]["K1_camera"] > 0
              and accept_counts[n]["K1"] % accept_counts[n]["K1_camera"] == 0
              and (n != 3 or row["segments"] == PORT_BENCH_SEGMENTS))
        accept_rows[n] = row
        print(f"phase 28 config {n} {c['scene']} {c['width']} px {c['spp']} spp depth "
              f"{c['depth']}: {'ok' if ok else 'FAIL'} segments {row['segments']} (reference "
              f"{ref['segments']}) mean_u8 {row['mean_u8']} (reference {ref['mean_u8']}, "
              f"{'recorded, not held' if n == 4 else 'held within 1.0'}) nonblack "
              f"{row['nonblack_frac']} (reference {ref['nonblack_frac']}) render "
              f"{row['seconds']:.4f} s {row['rays_per_s']:.4g} rays/s wall {row['wall_s']} s "
              f"kernel launches {accept_counts[n]} [{card}]")
        if not ok:
            failures.append(f"phase 28 config {n}")
    # K3, K2 and the fold replaying 50 bounces against their plain versions,
    # bit for bit (the fold to its float64 sum): a 400x225 chunk of config
    # 5's scene at its depth, and cornell_box, whose closed room keeps rays
    # bouncing past 32; then K2 and the fold at config 5's chunk size
    def fold_close(tb, g, ids, L, segs):
        """The fold's (L, 19) sum against fold_torch's in float64, bounce
        by bounce, at phase 11's bar for ``segs`` ray-bounces."""
        exact = torch.zeros((L, rk.NG), dtype=torch.float64, device=dev)
        for b in range(g.shape[0]):
            exact += tg.fold_torch(g[b:b + 1].double(), ids[b:b + 1], L)
        tb = tb[:, rk._TCOLS].double()
        err = float((tb - exact[:, rk._GSLOTS]).abs().max())
        ok = bool(torch.allclose(tb, exact[:, rk._GSLOTS], rtol=1e-5,
                                 atol=2e-6 * max(1, segs // L)))
        return ok, err

    for name5, w5, spp5 in (("bouncing_spheres", 400, 4), ("cornell_box", 64, 2)):
        s5s, c5s = build(name5, device=dev, image_width=w5, samples_per_pixel=spp5,
                         max_depth=50)
        table, ids, rfr, rir, ml, rbar, kw_r, _, len5 = replay_inputs(s5s, c5s, spp5,
                                                                      [2, 2, 3, 4, 39])
        rad_k3, bc_k3 = rk.replay_fwd(table, ids, rfr, rir, ml, **kw_r)
        g_k2 = rk.replay_bwd(table, ids, rfr, rir, rbar, ml, **kw_r)
        L = table.shape[0]
        before = int(tg.fold_launches)
        tb_k = rk.reduce_table_grads(g_k2, ids, L)
        torch.cuda.synchronize()
        rad_p3, bc_p3 = rk.replay_fwd_torch(table, ids, rfr, rir, ml, **kw_r)
        g_p2 = rk.replay_bwd_torch(table, ids, rfr, rir, rbar, ml, **kw_r)
        deep_m = len5 > 32
        deep = int(deep_m.sum())
        eq3_deep = bool(torch.equal(rad_k3[:, deep_m], rad_p3[:, deep_m]))
        eq3, eq2 = bool(torch.equal(rad_k3, rad_p3)), bool(torch.equal(g_k2, g_p2))
        fold_ok, fold_err = fold_close(tb_k, g_p2, ids, L, int(bc_p3.sum()))
        ok_deep = (eq3 and bool(torch.equal(bc_k3, bc_p3)) and eq2 and fold_ok
                   and int(tg.fold_launches) == before + 1 and deep > 0)
        print(f"phase 28 K3, K2 and the fold at depth 50, {name5} (B={rfr.shape[1]}, {deep} "
              f"rays past 32 bounces, longest {int(len5.max())}): {'ok' if ok_deep else 'FAIL'} "
              f"K3 bit-equal {eq3} (past 32 bounces {eq3_deep}) segments {int(bc_k3.sum())} "
              f"plain {int(bc_p3.sum())}; K2 bit-equal {eq2}; fold (on the card) max_abs_err "
              f"{fold_err:.3g} against float64")
        if not ok_deep:
            failures.append(f"phase 28 K3, K2 and the fold at depth 50, {name5}")
        del table, ids, rfr, rir, ml, rbar, g_k2, g_p2, tb_k
    # K2 at config 5's chunk (B = 3,244,032 rays, D = 50): its (50, 19, B)
    # output passes 2^31 elements, so it is held on the tiles of the rays
    # past 32 bounces (sorted first), a middle tile and the last tile, which
    # the plain version replays alone; the fold then sums the whole chunk
    c5 = acceptance.CONFIGS[5]
    s5c, c5c = build(c5["scene"], device=dev, image_width=c5["width"], samples_per_pixel=4,
                     max_depth=c5["depth"])
    table, ids, rfr, rir, ml, rbar, kw_r, seg5c, len5 = replay_inputs(s5c, c5c, 4,
                                                                      [2, 2, 3, 4, 39])
    n5c, L = rfr.shape[1], table.shape[0]
    g_k2 = rk.replay_bwd(table, ids, rfr, rir, rbar, ml, **kw_r)
    before = int(tg.fold_launches)
    tb_k = rk.reduce_table_grads(g_k2, ids, L)
    torch.cuda.synchronize()
    n_tiles = -(-n5c // rk.TILE)
    deep_tiles = -(-int((len5 > 32).sum()) // rk.TILE)
    held = ((0, deep_tiles), (n_tiles // 2, n_tiles // 2 + 1), (n_tiles - 1, n_tiles))
    tiles = sum(t1_ - t0_ for t0_, t1_ in held)
    eq5c = True
    for t0_, t1_ in held:
        sl = slice(t0_ * rk.TILE, min(t1_ * rk.TILE, n5c))
        g_p = rk.replay_bwd_torch(table, ids[:, sl].contiguous(), rfr[:, sl].contiguous(),
                                  rir[:, sl].contiguous(), rbar[:, sl].contiguous(),
                                  ml[t0_:t1_].contiguous(), **kw_r)
        eq5c &= bool(torch.equal(g_k2[:, :, sl], g_p))
    top = ((g_k2.shape[0] - 1) * rk.NG + rk.NG - 1) * n5c + n5c - 1  # last element checked
    fold5_ok, fold5_err = fold_close(tb_k, g_k2, ids, L, seg5c)
    ok5c = (eq5c and fold5_ok and int(tg.fold_launches) == before + 1 and g_k2.numel() >= 2 ** 31
            and deep_tiles > 0)
    print(f"phase 28 K2 and the fold at config 5's chunk (B={n5c}, D={g_k2.shape[0]}, output "
          f"{g_k2.numel()} elements, {tiles} tiles held up to element {top}): "
          f"{'ok' if ok5c else 'FAIL'} K2 bit-equal on the held tiles {eq5c}; fold (on the "
          f"card) max_abs_err {fold5_err:.3g} against float64 ({seg5c} ray-bounces)")
    if not ok5c:
        failures.append("phase 28 K2 and the fold at config 5's chunk")
    del table, ids, rfr, rir, ml, rbar, g_k2, tb_k
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fb5 = pbench._fwd_bwd_setup(width=c5["width"], spp=c5["spp"], max_depth=c5["depth"],
                                seed=SEED, spp_chunk=4, device=dev)
    zero_counts()
    fb5["plan"](fused=False)  # the chunk loop here; phase 32 holds the fused sweep to it
    torch.cuda.synchronize()
    plan5_s, plan5_counts = time.perf_counter() - t0, counts()
    zero_counts()
    t1 = time.perf_counter()
    _, gc5, gr5, seg5, ok5 = fb5["sweep"](fused=False)
    torch.cuda.synchronize()
    sweep5_s, sweep5_counts = time.perf_counter() - t1, counts()
    peak5 = torch.cuda.max_memory_allocated(dev)
    n5 = fb5["n_chunks"]
    ok28g = (bool(ok5) and int(seg5) == accept_rows[5]["segments"]
             and bool(torch.isfinite(gc5).all() and torch.isfinite(gr5).all())
             and float(gr5.abs().sum()) > 0
             and sweep5_counts == only(K1=5 * n5, K2=n5, fold=n5, K1_camera=n5, camera_rays=n5))
    print(f"phase 28 config 5 fwd+bwd ({n5} chunks of {fb5['B']} rays, spp_chunk 4): "
          f"{'ok' if ok28g else 'FAIL'} decision-pass segments {int(seg5)} (forward render "
          f"{accept_rows[5]['segments']}) plan {plan5_s:.3f} s sweep {sweep5_s:.3f} s "
          f"{int(seg5) / sweep5_s:.4g} rays/s peak device memory {peak5 / 2**30:.2f} GiB "
          f"rgb grad norm {float(gr5.norm()):.4g} kernel launches plan {plan5_counts} sweep "
          f"{sweep5_counts} [{card}]")
    if not ok28g:
        failures.append("phase 28 config 5 fwd+bwd")
    del gc5, gr5  # fb5 (planned) stays for phase 32

    # ---- phase 29: the stored C++ configurations through the default Renderer ----
    from raytracing_tpu_torch import cpp_compare

    cpp_counts, cpp_all = {}, []
    for scene_c, w, spp_c, d_c, mtol, nbtol in cpp_compare.CONFIGS:
        zero_counts()
        r29 = cpp_compare.run_config(scene_c, w, spp_c, d_c, mtol, nbtol, seed=SEED, device=dev)
        cpp_all.append(counts())
        cpp_counts[scene_c] = cpp_all[-1]["K1"]
        print(f"phase 29 {scene_c} {w} px {spp_c} spp depth {d_c}: "
              f"{'ok' if r29['pass'] else 'FAIL'} mean_u8 {r29['port']['mean']} (C++ "
              f"{r29['cpp']['mean']}, |d| {r29['mean_abs_diff_u8']} <= {mtol}) nonblack "
              f"{r29['port']['nonblack']} (C++ {r29['cpp']['nonblack']}, |d| "
              f"{r29['nonblack_abs_diff']} <= {nbtol}) shape {r29['port']['shape']} K1 launches "
              f"{cpp_counts[scene_c]}")
        if not r29["pass"]:
            failures.append(f"phase 29 {scene_c}")

    # ---- phase 30: the sharded renders: 2 ranks on this card over gloo, 1 over NCCL ----
    import tempfile as _tf

    import torch.distributed as dist

    from raytracing_tpu_torch.core.color import to_u8_image
    from raytracing_tpu_torch.entry import card_modes
    from raytracing_tpu_torch.parallel.mesh import make_mesh, spawn
    from raytracing_tpu_torch.parallel.shard import render_sharded

    bench_c = dict(scene="bouncing_spheres", width=400, spp=100, depth=20, seed=SEED)
    tp_c = dict(scene="bouncing_spheres", width=100, spp=4, depth=8, seed=SEED)
    spec = {"dp2_mega": dict(mesh=((2,), ("dp",)), hit="mega", **bench_c),
            "sp2_mega": dict(mesh=((1, 2), ("dp", "sp")), hit="mega", **bench_c),
            "dp1tp2_brute": dict(mesh=((1, 2), ("dp", "tp")), hit="brute", **tp_c),
            "dp2_bvh": dict(mesh=((2,), ("dp",)), hit="bvh", **tp_c),
            "dp1tp2_bvh": dict(mesh=((1, 2), ("dp", "tp")), hit="bvh", **tp_c)}
    t0 = time.perf_counter()
    ranks30 = spawn(card_modes, 2, backend="gloo", device="cuda", args=(spec,))
    spawn_s = time.perf_counter() - t0
    ref30 = whole.radiance  # phase 25: the bench render, bit-equal to phase 3's
    s30, c30 = build("bouncing_spheres", device=dev, image_width=100, samples_per_pixel=4,
                     max_depth=8)
    ref_tp = Renderer(c30, hit_method="brute").render(s30, seed=SEED)
    ref_bvh = Renderer(c30, hit_method="bvh").render(s30, seed=SEED)
    ok30 = True
    rows30 = {}
    for name in spec:
        r0 = ranks30[0][name]
        same_ranks = all(np.array_equal(r[name]["img"], r0["img"]) and
                         r[name]["segments"] == r0["segments"] for r in ranks30)
        walk = [r[name]["walk"] for r in ranks30]
        if name == "dp1tp2_brute":
            err = float(np.abs(r0["img"] - ref_tp.radiance).max())
            ok = err <= 1e-5 and r0["segments"] == ref_tp.segments
        elif name == "dp2_bvh":  # every rank walks the whole BVH
            err = float(np.abs(r0["img"] - ref_bvh.radiance).max())
            ok = err <= 1e-5 and r0["segments"] == ref_bvh.segments and min(walk) > 0
        elif name == "dp1tp2_bvh":  # each rank its range's BVH: rare exact ties may flip
            diff = np.abs(r0["img"] - ref_bvh.radiance).max(axis=-1)
            err = float((diff > 1e-4).mean())
            ok = (err < 0.002 and segments_close(ref_bvh.segments, r0["segments"])
                  and min(walk) > 0)
        else:
            err = float(np.abs(r0["img"] - ref30).max())
            ok = (r0["segments"] == PORT_BENCH_SEGMENTS
                  and (err == 0.0 if name == "dp2_mega" else err <= 1e-5))
        if name == "dp2_mega":
            u8 = to_u8_image(torch.from_numpy(r0["img"]).to(dev)).cpu().numpy()
            ok = ok and bool(np.array_equal(u8, img))
        k1 = [r[name]["K1"] for r in ranks30]
        ok = ok and same_ranks and (spec[name]["hit"] != "mega" or all(x > 0 for x in k1))
        ok30 &= ok
        rows30[name] = dict(K1_per_rank=k1, walk_per_rank=walk,
                            seconds_per_rank=[round(r[name]["seconds"], 4) for r in ranks30])
        against = {"brute": "the single-process brute render",
                   "bvh": "the single-process bvh render"}.get(spec[name]["hit"],
                                                               "phase 3's single-process render")
        what = "share of pixels off by > 1e-4" if name == "dp1tp2_bvh" else "max_abs_err"
        print(f"phase 30 {name} (2 ranks on {dev} over gloo): {'ok' if ok else 'FAIL'} {what} "
              f"{err:.3g} against {against}, segments {r0['segments']} ranks equal {same_ranks} "
              f"K1 launches per rank {k1} walk launches per rank {walk} walls per rank "
              f"{rows30[name]['seconds_per_rank']} s [{card}]")
    # 1 rank over NCCL in this process
    nccl_dir = _tf.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", store=dist.FileStore(str(Path(nccl_dir) / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh1 = make_mesh((1,), ("dp",), device=dev)
        s1, c1 = build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=100,
                       max_depth=20)
        render_sharded(s1, c1, mesh1, seed=SEED, hit_method="mega")  # warm-up
        zero_counts()
        t0 = time.perf_counter()
        img1, seg1 = render_sharded(s1, c1, mesh1, seed=SEED, hit_method="mega")
        nccl_s = time.perf_counter() - t0
        nccl_counts = counts()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(nccl_dir, ignore_errors=True)
    ok_nccl = (bool(np.array_equal(img1, ref30)) and seg1 == PORT_BENCH_SEGMENTS
               and nccl_counts == only(K1=nccl_counts["K1"]) and nccl_counts["K1"] > 0)
    ok30 &= ok_nccl
    rows30["dp1_mega_nccl"] = dict(K1_per_rank=[nccl_counts["K1"]],
                                   seconds_per_rank=[round(nccl_s, 4)])
    print(f"phase 30 dp1_mega (1 rank over NCCL): {'ok' if ok_nccl else 'FAIL'} bit-equal "
          f"{bool(np.array_equal(img1, ref30))} segments {seg1} K1 launches "
          f"{nccl_counts['K1']} wall {nccl_s:.4f} s; spawn of the 2 ranks {spawn_s:.1f} s "
          f"[{card}]")
    if not ok30:
        failures.append("phase 30 sharded renders")
    # every kernel's launches in phases 28-30 (the sharded renders' ranks: K1 and K5)
    new_paths = {k: sum(c[k] for c in [*accept_counts.values(), plan5_counts, sweep5_counts,
                                       *cpp_all, nccl_counts]) for k in counts()}
    for r in ranks30:
        for v in r.values():
            new_paths["K1"] += v["K1"]
            new_paths["K5"] += v["K5"]
            new_paths["walk"] += v["walk"]

    # ---- phase 31: replays past 64 bounces: K3, K2 and the fold ----
    from raytracing_tpu_torch.render.camera import CameraConfig
    from raytracing_tpu_torch.scene.builder import SceneBuilder
    from torch_parity import deep_scene, deep_scene_config

    def fold_rows_close(tb, g, ids, L, prefixes=None):
        """The replay's table reduction ``tb`` (reduce_table_grads' (L,
        N_FIELDS)) of ``g (D, NG, n)`` over the per-bounce ray ``prefixes``
        against fold_torch's float64 sum of the same, bounce by bounce, at
        phase 11's bar with each row's own count: rtol 1e-5 and atol 2e-6
        per ray-bounce that row takes. Returns (ok, max_abs_err, relative L2
        error)."""
        D, n = ids.shape
        exact = torch.zeros((L, rk.NG), dtype=torch.float64, device=dev)
        takes = torch.zeros(L, dtype=torch.int64, device=dev)
        for b, p in enumerate(tg._prefix_list(prefixes, D, n)):
            exact += tg.fold_torch(g[b:b + 1].double(), ids[b:b + 1], L, [p])
            hit = ids[b, :p]
            takes += torch.bincount(hit[hit >= 0].long(), minlength=L)
        exact, tb = exact[:, rk._GSLOTS], tb[:, rk._TCOLS].double()
        err = (tb - exact).abs()
        atol = 2e-6 * takes.clamp(min=1).double()[:, None]
        return (bool((err <= atol + 1e-5 * exact.abs()).all()), float(err.max()),
                float((tb - exact).norm() / exact.norm()))

    def first_window(g, ids, L, prefixes=None):
        """The fold of the first window of bounces alone (a dropped
        window): what the check above must tell from the whole fold."""
        w = tg.FOLD_MAX_D
        return rk.reduce_table_grads(g[:w], ids[:w], L,
                                     tg._prefix_list(prefixes, *ids.shape)[:w])

    # K3 and K2 bit for bit against their plain versions at depth 96 on the
    # deep scene (the camera inside a fuzz-0 metal sphere) and cornell_box,
    # the rays past 64 bounces held apart too, and the fold of the 96
    # bounces on the card in two windows (two launches), over every ray and
    # over the planned prefixes, within phase 11's bar of its float64 sum;
    # on the deep scene the first window alone must fail that bar
    ok31 = True
    for name31 in ("deep", "cornell_box"):
        if name31 == "deep":
            s31 = deep_scene(SceneBuilder()).compile(dev)
            c31 = deep_scene_config(CameraConfig, image_width=64, samples_per_pixel=2,
                                    max_depth=96)
        else:
            s31, c31 = build(name31, device=dev, image_width=64, samples_per_pixel=2,
                             max_depth=96)
        table, ids, rfr, rir, ml, rbar, kw_r, _, len31 = replay_inputs(s31, c31, 2,
                                                                       [2, 2, 3, 4, 85])
        rad_k3, bc_k3 = rk.replay_fwd(table, ids, rfr, rir, ml, **kw_r)
        g_k2 = rk.replay_bwd(table, ids, rfr, rir, rbar, ml, **kw_r)
        L, n31 = table.shape[0], rfr.shape[1]
        pref31 = rk.plan_prefixes(torch.bincount(len31.long(), minlength=97).cpu(), n31, 96,
                                  margin=1.0)
        before = int(tg.fold_launches)
        tb_k = rk.reduce_table_grads(g_k2, ids, L)
        tb_kp = rk.reduce_table_grads(g_k2, ids, L, pref31)
        torch.cuda.synchronize()
        fold_n = int(tg.fold_launches) - before
        tb_w1 = first_window(g_k2, ids, L, pref31)
        rad_p3, bc_p3 = rk.replay_fwd_torch(table, ids, rfr, rir, ml, **kw_r)
        g_p2 = rk.replay_bwd_torch(table, ids, rfr, rir, rbar, ml, **kw_r)
        deep_m = len31 > 64
        n_deep = int(deep_m.sum())
        eq3 = bool(torch.equal(rad_k3, rad_p3) and torch.equal(bc_k3, bc_p3))
        eq2 = bool(torch.equal(g_k2, g_p2))
        eq3_deep = bool(torch.equal(rad_k3[:, deep_m], rad_p3[:, deep_m])
                        and torch.equal(bc_k3[deep_m], bc_p3[deep_m]))
        eq2_deep = bool(torch.equal(g_k2[:, :, deep_m], g_p2[:, :, deep_m]))
        fold_ok, fold_err, _ = fold_rows_close(tb_k, g_p2, ids, L)
        foldp_ok, foldp_err, _ = fold_rows_close(tb_kp, g_p2, ids, L, pref31)
        w1_ok, w1_err, w1_rel = fold_rows_close(tb_w1, g_p2, ids, L, pref31)
        ok = (eq3 and eq2 and fold_ok and foldp_ok and fold_n == 4
              and len(tg.fold_windows(96, pref31)) == 2
              and (name31 != "deep" or (n_deep > 0 and not w1_ok)))
        ok31 &= ok
        print(f"phase 31 K3, K2 and the fold at depth 96, {name31} (B={n31}, {n_deep} "
              f"rays past 64 bounces, longest {int(len31.max())}): {'ok' if ok else 'FAIL'} K3 "
              f"bit-equal {eq3} (past 64 bounces {eq3_deep}) segments {int(bc_k3.sum())} plain "
              f"{int(bc_p3.sum())}; K2 bit-equal {eq2} (past 64 bounces {eq2_deep}); fold (on "
              f"the card, {fold_n} launches in two calls) against float64 at phase 11's bar "
              f"per row: every ray {fold_ok} max_abs_err {fold_err:.3g}, planned prefixes "
              f"{foldp_ok} max_abs_err {foldp_err:.3g}; the first window alone {w1_ok} "
              f"max_abs_err {w1_err:.3g} relative L2 {w1_rel:.3g} (must fail on the deep scene)")
        del table, ids, rfr, rir, ml, rbar, g_k2, g_p2, tb_k, tb_kp, tb_w1
    # K2 and the fold on the bench chunk (400x225, spp_chunk 4, B = 360,448)
    # traced at depths 20, 50 and 100: K2 bit-equal to its plain version and
    # timed; the fold over the planned prefixes, one launch per window of
    # 64 bounces, within phase 11's bar per row of the float64 sum (the
    # first window alone must fail it); then replay_trace_kernel (K3
    # forward, K2 backward) at 100
    k2_depth = {}
    for D31 in (20, 50, 100):
        s31, c31 = build("bouncing_spheres", device=dev, image_width=400,
                         samples_per_pixel=100, max_depth=D31)
        table, ids, rfr, rir, ml, rbar, kw_r, seg31, len31 = replay_inputs(
            s31, c31, 4, [2, 2, 3, 4, D31 - 11])
        n31, L = rfr.shape[1], table.shape[0]
        g_k2 = rk.replay_bwd(table, ids, rfr, rir, rbar, ml, **kw_r)
        torch.cuda.synchronize()
        g_p2 = rk.replay_bwd_torch(table, ids, rfr, rir, rbar, ml, **kw_r)
        eq2 = bool(torch.equal(g_k2, g_p2))
        ms2 = device_ms(torch, lambda: rk.replay_bwd(table, ids, rfr, rir, rbar, ml, **kw_r), 5)
        b2 = bound(seg31 * K2_OPS_PER_SEGMENT, n31 * (rk.N_RAY_F * 4 + 8 + 12 + 4) + 4 * seg31
                   + 4 * table.numel() + 4 * g_k2.numel())
        pref31 = rk.plan_prefixes(torch.bincount(len31.long(), minlength=D31 + 1).cpu(), n31,
                                  D31, margin=1.0)
        before = int(tg.fold_launches)
        tb31 = rk.reduce_table_grads(g_k2, ids, L, pref31)
        torch.cuda.synchronize()
        fold_n = int(tg.fold_launches) - before
        fold_ms = device_ms(torch, lambda: tg.fold(g_k2, ids, L, pref31), 10)
        # the fold over the planned prefixes against the float64 sum of K2's
        # plain version's cotangents, at phase 11's bar per row
        f_ok, f_err, f_rel = fold_rows_close(tb31, g_p2, ids, L, pref31)
        row = dict(bit_equal=eq2, ms=ms2, bound_ms=b2[0], bound_by=b2[1],
                   output_bytes=4 * g_k2.numel(), segments=seg31, longest=int(len31.max()),
                   past_64=int((len31 > 64).sum()), fold_windows=len(tg.fold_windows(D31, pref31)),
                   fold_launches=fold_n, fold_ms=fold_ms, fold_ok=f_ok,
                   fold_max_abs_err=f_err, fold_rel_l2=f_rel)
        ok = eq2 and f_ok and fold_n == row["fold_windows"] == (2 if D31 > 64 else 1)
        if D31 > 64:  # a dropped window must fail the same check
            w1 = fold_rows_close(first_window(g_k2, ids, L, pref31), g_p2, ids, L, pref31)
            row["first_window_alone"] = dict(ok=w1[0], max_abs_err=w1[1], rel_l2=w1[2])
            ok &= not w1[0]
        del g_k2, g_p2, tb31
        if D31 == 100:  # replay_trace_kernel forward and backward at depth 100
            rgb = s31.textures.rgb.clone().requires_grad_(True)
            scene_g = dataclasses.replace(s31, textures=dataclasses.replace(s31.textures, rgb=rgb))
            o_s, d_s, t_s = rfr[rk.RX:rk.RZ + 1].T, rfr[rk.RDX:rk.RDZ + 1].T, rfr[rk.RTM]
            rad_p3, bc_p3 = rk.replay_fwd_torch(table, ids, rfr, rir, ml, **kw_r)
            zero_counts()
            rad_t, seg_t = rk.replay_trace_kernel(scene_g, ids, o_s, d_s, t_s, rir[0], rir[1],
                                                  c31.background, D31, SEED,
                                                  active0=rfr[rk.RACT] > 0, lengths=len31)
            (rad_t * rbar.T).sum().backward()
            torch.cuda.synchronize()
            rt100_counts = counts()
            rt_ok = (rt100_counts == only(K3=1, K2=1, fold=2) and int(seg_t) == int(bc_p3.sum())
                     and bool(torch.equal(rad_t.detach(), rad_p3.T))
                     and bool(torch.isfinite(rgb.grad).all()) and float(rgb.grad.abs().sum()) > 0)
            row["replay_trace_kernel"] = dict(ok=rt_ok, launches=rt100_counts,
                                              segments=int(seg_t),
                                              rgb_grad_norm=float(rgb.grad.norm()))
            ok &= rt_ok
            del rgb, scene_g, rad_t
        ok31 &= ok
        k2_depth[D31] = row
        print(f"phase 31 bench chunk at depth {D31} (B={n31}): {'ok' if ok else 'FAIL'} "
              f"{json.dumps(row)} [{card}]")
        del table, ids, rfr, rir, ml, rbar, len31
    torch.cuda.empty_cache()
    # the fwd+bwd bench sweep at depth 100 (phases [2, 2, 3, 4, 89]: K1 with
    # ids and counts, K2 at D = 100, the fold in two windows a chunk) beside
    # the same sweep at depth 20: walls, launches and peak device memory; its
    # segments against a forward render's at depth 100; chunk 0's K2
    # against its plain version and its fold against the float64 sum
    sweeps31 = {}
    for D31 in (20, 100):
        fb31 = pbench._fwd_bwd_setup(max_depth=D31, device=dev)
        fb31["plan"]()
        # the peak of the first sweep: its warm-up chunk and the capture
        # allocate what a chunk needs (the replays reuse the graph's pool)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fb31["sweep"]()
        torch.cuda.synchronize()
        peak31 = torch.cuda.max_memory_allocated(dev)
        zero_counts()
        t0 = time.perf_counter()
        _, gc31, gr31, segs31, okp31 = fb31["sweep"]()
        torch.cuda.synchronize()
        wall31 = time.perf_counter() - t0
        c31s = counts()
        n_ch = fb31["n_chunks"]
        windows = len(tg.fold_windows(D31, fb31["ns"]["prefixes"]))
        row = dict(wall_s=wall31, segments=int(segs31), plan_ok=bool(okp31), launches=c31s,
                   fold_windows=windows, peak_bytes=peak31,
                   grads_finite=bool(torch.isfinite(gc31).all() and torch.isfinite(gr31).all()),
                   grad_rgb_norm=float(gr31.norm()))
        ok = (row["plan_ok"] and row["grads_finite"] and row["grad_rgb_norm"] > 0
              and c31s == only(K1=5 * n_ch, K2=n_ch, fold=windows * n_ch, K1_camera=n_ch,
                               camera_rays=n_ch)
              and windows == (2 if D31 > 64 else 1))
        if D31 == 100:
            s100, c100 = build("bouncing_spheres", device=dev, image_width=400,
                               samples_per_pixel=100, max_depth=D31)
            fwd100 = Renderer(c100, hit_method="mega", max_rays_per_launch=1 << 18,
                              phase_depths=[2, 2, 3, 4, D31 - 11]).render(s100, seed=SEED)
            row["forward_render_segments"] = fwd100.segments
            # chunk 0 through the sweep's own path (grads_chunk) with K2's
            # output and the reduction's inputs captured: K2 bit-equal to its
            # plain version on the same inputs, and the fold over the planned
            # prefixes (two launches) within phase 11's bar per row of the
            # float64 sum of the plain cotangents, and within phase 5's
            # relative-L2 bar (1e-4) of it
            seen = {}
            real = rk.replay_bwd, rk.reduce_table_grads

            def bwd_seen(*a, **k):
                seen["bwd"], seen["g"] = (a, k), real[0](*a, **k)
                return seen["g"]

            def red_seen(g, ids, L, prefixes=None):
                seen["red"], seen["tb"] = (ids, L, prefixes), real[1](g, ids, L, prefixes)
                return seen["tb"]

            rk.replay_bwd, rk.reduce_table_grads = bwd_seen, red_seen
            try:
                zero_counts()
                kern = fb31["grads_chunk"](*fb31["args"], 0)
                torch.cuda.synchronize()
                c0 = counts()
            finally:
                rk.replay_bwd, rk.reduce_table_grads = real
            g_plain = rk.replay_bwd_torch(*seen["bwd"][0], **seen["bwd"][1])
            k2_eq0 = bool(torch.equal(seen["g"], g_plain))
            ids0, L0, pref0 = seen["red"]
            f_ok, f_err, f_rel = fold_rows_close(seen["tb"], g_plain, ids0, L0, pref0)
            del seen, g_plain

            # the chunk's scene gradients with other sums in the fold's place,
            # each against those with the float64 sum: the fold (above), the
            # plain version's float32 index_add_ and the first window alone
            def chunk0_with(fold_fn):
                real_fold = rk.fold
                rk.fold = fold_fn
                try:
                    return fb31["grads_chunk"](*fb31["args"], 0)
                finally:
                    rk.fold = real_fold

            def grads(r):
                return torch.cat([r[1].flatten(), r[2].flatten()])

            g64 = grads(chunk0_with(lambda g, ids, L, prefixes=None: tg.fold_torch(
                g.double(), ids, L, prefixes).float()))
            g32 = grads(chunk0_with(tg.fold_torch))
            g_w1 = grads(chunk0_with(lambda g, ids, L, prefixes=None: tg.fold(
                g[:tg.FOLD_MAX_D], ids[:tg.FOLD_MAX_D], L,
                tg._prefix_list(prefixes, *ids.shape)[:tg.FOLD_MAX_D])))
            rel = {k: float((v - g64).norm() / g64.norm()) for k, v in (
                ("fold", grads(kern)), ("index_add_", g32), ("first_window_alone", g_w1))}
            rel["fold_vs_index_add_"] = float((grads(kern) - g32).norm() / g32.norm())
            row["chunk0"] = dict(launches=c0, k2_bit_equal=k2_eq0, fold_ok=f_ok,
                                 fold_max_abs_err=f_err, fold_rel_l2=f_rel,
                                 fold_windows=len(tg.fold_windows(D31, pref0)),
                                 grad_rel_l2_vs_float64_sum=rel,
                                 grad_norms=dict(center=float(kern[1].norm()),
                                                 rgb=float(kern[2].norm())))
            ok &= (fwd100.segments == row["segments"] and bool(kern[3]) and k2_eq0 and f_ok
                   and f_rel < 1e-4
                   and c0 == only(K1=5, K2=1, fold=2, K1_camera=1, camera_rays=1))
            del kern, g64, g32, g_w1
        ok31 &= ok
        sweeps31[D31] = row
        print(f"phase 31 fwd+bwd bench sweep at depth {D31} ({n_ch} chunks of {fb31['B']} rays): "
              f"{'ok' if ok else 'FAIL'} {json.dumps(row)} [{card}]")
        del fb31, gc31, gr31
        torch.cuda.empty_cache()
    if not ok31:
        failures.append("phase 31 replays past 64 bounces")

    # ---- phase 32: the fused single dispatch against the launch loop ----
    # tools/time_fused.py: one launch (or chunk) captured once as a CUDA
    # graph and replayed once a launch, against fused=False, in turns
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import time_fused as tf
    from raytracing_tpu_torch.scene.types import TEX_CHECKER

    rows32 = {}
    s32, c32 = build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=100,
                     max_depth=20)
    kw32 = dict(hit_method="mega", max_rays_per_launch=1 << 18, transfer="u8",
                phase_depths=[2, 2, 3, 4, c32.max_depth - 11])
    p32 = rows32["bench_plan"] = tf.compare_plans(s32, c32, kw32)
    n_launch = math.prod(Renderer(c32, **kw32)._grid())
    ok = (p32["equal"] and p32["fused"]["prefixes"] == pref
          and p32["loop"]["counts"]["K1"] == 5 * n_launch
          and p32["fused"]["counts"]["K1"] == 5 * (n_launch + 1))  # + the warm-up launch
    print(f"phase 32 bench plan fused against the loop: {'ok' if ok else 'FAIL'} "
          f"{json.dumps(p32)} [{card}]")
    ok32 = ok
    r32 = rows32["bench_render"] = tf.compare_renders(s32, c32, dict(kw32, phase_prefixes=pref))
    ok = (r32["equal"] and r32["f32_equal"] and r32["segments"] == PORT_BENCH_SEGMENTS
          and r32["ok"] is True
          and r32["counts_fused"] == r32["counts_loop"] == only(K1=250, K1_camera=50))
    print(f"phase 32 bench render fused against the loop: {'ok' if ok else 'FAIL'} "
          f"{json.dumps(r32)} [{card}]")
    ok32 &= ok
    s64b, c64b = bouncing_spheres_64(dev)
    r64 = rows32["bouncing_spheres_64_render"] = tf.compare_renders(
        s64b, c64b, dict(max_rays_per_launch=1 << 18, transfer="u8",
                         phase_depths=[2, 2, 3, 4, c64b.max_depth - 11]))
    ok = (r64["equal"] and r64["f32_equal"]
          and r64["counts_fused"] == r64["counts_loop"] == only(K5=5 * r64["launches"]))
    print(f"phase 32 bouncing_spheres_64 render (K5) fused against the loop: "
          f"{'ok' if ok else 'FAIL'} {json.dumps(r64)} [{card}]")
    ok32 &= ok
    del s64b, c64b

    # the bench sweep (phase 6's planned setup), fused and unfused, each
    # held to the sweep with a float64 fold (per row: phase 11's bar for the
    # ray-bounces the gradient row gathers; whole: phase 5's relative L2)
    sw = rows32["bench_sweep"] = tf.compare_sweeps(fbs)
    hits = {}

    def fold64(g, ids, L, prefixes=None):
        h = hits.setdefault("rows", torch.zeros(L, dtype=torch.float64, device=dev))
        for b, P in enumerate(tg._prefix_list(prefixes, *ids.shape)):
            h.index_add_(0, ids[b, :P].clamp(0, L - 1).long(),
                         torch.ones(P, dtype=torch.float64, device=dev))
        return tg.fold_torch(g.double(), ids, L, prefixes).float()

    real_fold = rk.fold
    rk.fold = fold64
    try:
        _, gc64, gr64, seg64, _ = fbs["sweep"](fused=False)
    finally:
        rk.fold = real_fold
    fused_g = fbs["sweep"](fused=True)
    loop_g = fbs["sweep"](fused=False)
    mats, texs = s32.materials, s32.textures
    tid = mats.tex_id[s32.spheres.mat_id.long()].long()
    chk = texs.ttype[tid] == TEX_CHECKER
    n_sph = s32.n_spheres
    row_hits = hits["rows"][:n_sph]
    tex_hits = torch.zeros(texs.rgb.shape[0], dtype=torch.float64, device=dev)
    for col in (0, 1):  # the even and the odd texture columns of each row
        tex_hits.index_add_(0, torch.where(chk, texs.child[tid, col].long(), tid), row_hits)

    def grads_close(gc, gr):
        rel = float((gr.double() - gr64.double()).norm() / gr64.double().norm())
        rows_ok = bool(torch.all((gr.double() - gr64.double()).abs()
                                 <= 1e-5 * gr64.double().abs() + 2e-6 * tex_hits[:, None]))
        rows_ok &= bool(torch.all((gc.double() - gc64.double()).abs()
                                  <= 1e-5 * gc64.double().abs() + 2e-6 * row_hits[:, None]))
        return rel, rows_ok

    rel_f, rows_f = grads_close(fused_g[1], fused_g[2])
    rel_l, rows_l = grads_close(loop_g[1], loop_g[2])
    sw.update(grad_rgb_rel_l2_vs_float64_fused=rel_f, grad_rgb_rel_l2_vs_float64_loop=rel_l,
              rows_within_bar_fused=rows_f, rows_within_bar_loop=rows_l)
    expect = only(K1=5 * fbs["n_chunks"], K2=fbs["n_chunks"], fold=fbs["n_chunks"],
                  K1_camera=fbs["n_chunks"], camera_rays=fbs["n_chunks"])
    ok = (sw["loss"] == sw["loss_loop"] and sw["segments"] == sw["segments_loop"]
          == PORT_BENCH_SEGMENTS == int(seg64) and sw["ok"] and sw["ok_loop"]
          and sw["counts_fused"] == sw["counts_loop"] == expect
          and rel_f < 1e-4 and rel_l < 1e-4 and rows_f and rows_l
          and sw["grad_rgb_rel_l2"] < 1e-4)
    print(f"phase 32 bench fwd+bwd sweep fused against unfused: {'ok' if ok else 'FAIL'} "
          f"{json.dumps(sw)} [{card}]")
    ok32 &= ok
    del fused_g, loop_g, gc64, gr64

    # BASELINE config 5: the default Renderer fused and looped (phase 28
    # rendered it fused), then phase 28's planned sweep fused and unfused
    c5 = acceptance.CONFIGS[5]
    s5r, c5r = build(c5["scene"], device=dev, image_width=c5["width"],
                     samples_per_pixel=c5["spp"], max_depth=c5["depth"])
    torch.cuda.empty_cache()
    r5 = rows32["config5_render"] = tf.compare_renders(s5r, c5r, {}, reps=1)
    ok = (r5["equal"] and r5["segments"] == accept_rows[5]["segments"]
          and r5["counts_fused"] == r5["counts_loop"]
          == only(K1=r5["counts_loop"]["K1"], K1_camera=r5["counts_loop"]["K1_camera"])
          and r5["counts_loop"]["K1_camera"] > 0
          and r5["counts_loop"]["K1"] % r5["counts_loop"]["K1_camera"] == 0)
    print(f"phase 32 config 5 render fused against the loop: {'ok' if ok else 'FAIL'} "
          f"{json.dumps(r5)} [{card}]")
    ok32 &= ok
    del s5r, c5r
    torch.cuda.empty_cache()
    sw5 = rows32["config5_sweep"] = tf.compare_sweeps(fb5, reps=1)
    ok = (sw5["loss"] == sw5["loss_loop"] and sw5["segments"] == sw5["segments_loop"]
          == int(seg5) and sw5["ok"] and sw5["ok_loop"] and sw5["grad_rgb_rel_l2"] < 1e-4
          and sw5["counts_fused"] == sw5["counts_loop"])
    print(f"phase 32 config 5 fwd+bwd sweep fused against unfused: {'ok' if ok else 'FAIL'} "
          f"{json.dumps(sw5)} [{card}]")
    ok32 &= ok
    del fb5
    torch.cuda.empty_cache()
    if not ok32:
        failures.append("phase 32 fused single dispatch")

    # ---- phase 33: the pool's single dispatch against its host loop ----
    # tools/time_fused.py --pool: each sample window one launch of a CUDA
    # graph with a device-side WHILE loop (fused, the default) against
    # fused=False, in turns; fused renders after their capture run under
    # torch.cuda.set_sync_debug_mode("error") until the copy to the host
    torch.cuda.empty_cache()
    rows33 = tf.compare_pools(dev, config5=True)
    expect33 = {"bench_pool": (PORT_BENCH_SEGMENTS, POOL_BENCH_K1),
                "bouncing_spheres_64_pool": (xw.segments, cw["K1"]),
                **{f"{n}_pool": (None, reg_counts[n]["pool"]) for n in tf.POOL_SCENES},
                "config5_pool": (accept_rows[5]["segments"], None)}
    ok33 = True
    for name33, row in rows33.items():
        seg33, k1_33 = expect33[name33]
        ok = (row["equal"] and row.get("f32_equal", True)
              and row["counts_fused"] == row["counts_loop"]
              == only(K1=row["counts_loop"]["K1"]) and row["counts_loop"]["K1"] > 0
              and (seg33 is None or row["segments"] == seg33)
              and (k1_33 is None or row["counts_loop"]["K1"] == k1_33))
        print(f"phase 33 {name33} fused against the host loop: {'ok' if ok else 'FAIL'} "
              f"{json.dumps(row)} [{card}]")
        ok33 &= ok
    ok33 &= rows33["bouncing_spheres_64_pool"]["counts_loop"]["K1"] == 64
    ok33 &= rows33["config5_pool"]["launches"] == 25
    if not ok33:
        failures.append("phase 33 the pool's single dispatch")

    # ---- phase 34: camera rays where they are used, at the cells' launch shapes ----
    torch.cuda.empty_cache()
    ok34, rows34, times34 = camera_phase(torch, dev, card)
    if not ok34:
        failures.append("phase 34 camera rays")

    # ---- phase 35: participating media in K1, at next_week_final's launch shape ----
    torch.cuda.empty_cache()
    ok35, row35 = medium_phase(torch, dev, card)
    if not ok35:
        failures.append("phase 35 K1 with media")

    print(f"card: {card}")  # again near the end, inside a tail of the output
    print(json.dumps({"kernels": [
        {"name": "K1 megakernel_block (BVH walk; the guarded sweep below CULL_MIN_PRIMS)",
         "route": "cuda", "source": "raytracing_tpu_torch/csrc/megakernel_block.cu",
         "replaces": "raytracing_tpu/ops/megakernel_block.py:155",
         "launches_phases_28_30": new_paths["K1"],
         "launches": render_counts["K1"], "path": "forward render (phase 3)",
         "launches_fwd_bwd_sweep": fb_counts["K1"],
         "launches_pool_render": pool_counts["K1"], "launches_registry_renders": reg_counts,
         "launches_pool_render_bouncing_spheres_64": cw["K1"],
         "launches_cli_render": cli_counts["K1"], "launches_resumed_render": resumed_counts["K1"],
         "launches_acceptance": {n: c["K1"] for n, c in accept_counts.items()},
         "launches_acceptance_config5_plan": plan5_counts["K1"],
         "launches_acceptance_config5_sweep": sweep5_counts["K1"],
         "launches_cpp_compare": cpp_counts,
         "launches_fused_bench_render": rows32["bench_render"]["counts_fused"]["K1"],
         "launches_fused_bench_sweep": rows32["bench_sweep"]["counts_fused"]["K1"],
         "launches_fused_pool_render": rows33["bench_pool"]["counts_fused"]["K1"],
         "launches_fused_pool_render_config5": rows33["config5_pool"]["counts_fused"]["K1"],
         "launches_sharded_per_rank": {k: v["K1_per_rank"] for k, v in rows30.items()},
         "max_abs_err": stats["max_abs_err"], "ms": ms, "ms_sweep": ms_sweep,
         "plain_ms": plain_ms, "bound_ms": k1_walk_bound[0], "bound_by": k1_walk_bound[1],
         "bound_sweep_ms": k1_sweep_bound[0], "bound_sweep_by": k1_sweep_bound[1],
         "library_ms": None, "bouncing_spheres_64_full_width": k1_64,
         "bouncing_spheres_64_pool_shaped": k1_pool64,
         **{f"{k}_full_width": v["k1"] for k, v in tex_rows.items()},
         "next_week_final_first_launch": {k: row35[k] for k in (
             "k1_ms_with_media", "k1_ms_without_media", "ns_per_segment_with_media",
             "ns_per_segment_without_media", "bit_equal")}},
        {"name": "K3 replay_fwd", "route": "cuda",
         "source": "raytracing_tpu_torch/csrc/replay_kernel.cu",
         "replaces": "raytracing_tpu/diff/replay_kernel.py:594",
         "launches_phases_28_30": new_paths["K3"],
         "launches": rt_counts["K3"], "path": "replay_trace_kernel (phase 7)",
         "max_abs_err": float(d3.max()), "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None,
         "ms_in_turns": {d: v["ms"] for d, v in k3_probe.items()},
         "lane_share": {d: v["lanes"] for d, v in k3_probe.items()},
         "launches_depth100_replay_trace_kernel": rt100_counts["K3"]},
        {"name": "K2 replay_bwd", "route": "cuda",
         "source": "raytracing_tpu_torch/csrc/replay_kernel.cu",
         "replaces": "raytracing_tpu/diff/replay_kernel.py:637",
         "launches_phases_28_30": new_paths["K2"],
         "launches": fb_counts["K2"], "path": "one fwd+bwd bench sweep (phase 6)",
         "launches_acceptance_config5_sweep": sweep5_counts["K2"],
         "max_abs_err": k2_err, "tbar_rel_l2": rel2, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None,
         "launches_depth100_sweep": sweeps31[100]["launches"]["K2"],
         "launches_fused_bench_sweep": rows32["bench_sweep"]["counts_fused"]["K2"],
         "ms_by_depth": {d: v["ms"] for d, v in k2_depth.items()},
         "bound_ms_by_depth": {d: v["bound_ms"] for d, v in k2_depth.items()},
         "bit_equal_by_depth": {d: v["bit_equal"] for d, v in k2_depth.items()}},
        {"name": "K5 megakernel_group", "route": "cuda",
         "source": "raytracing_tpu_torch/csrc/megakernel_group.cu",
         "replaces": "raytracing_tpu/ops/megakernel.py:285",
         "launches_phases_28_30": new_paths["K5"],
         "launches": k5_counts["K5"], "path": "bouncing_spheres_64 render (phase 10)",
         "launches_fused_render": rows32["bouncing_spheres_64_render"]["counts_fused"]["K5"],
         **k5_entry, "library_ms": None,
         **{f"{k}_full_width": v["k5"] for k, v in tex_rows.items()}},
        {"name": "K4 table_gather", "route": "cuda",
         "source": "raytracing_tpu_torch/csrc/table_gather.cu",
         "replaces": "raytracing_tpu/ops/table_gather.py:42",
         "launches_phases_28_30": new_paths["K4"],
         "launches": sweep12_counts["K4"], "path": "replay_trace_fast sweep (phase 12)",
         **{k: k4_rows[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
         "L4224": {k: k4_rows[1][k] for k in ("ms", "plain_ms", "bound_ms")}},
        {"name": "fold table_fold (K4's backward, the replay's table reduction)",
         "route": "cuda", "source": "raytracing_tpu_torch/csrc/table_gather.cu",
         "replaces": "raytracing_tpu/ops/table_gather.py:117 (_bwd, the one-hot VJP of K4)",
         "launches_phases_28_30": new_paths["fold"],
         "launches": sweep12_counts["fold"], "path": "replay_trace_fast sweep (phase 12)",
         "launches_fwd_bwd_sweep": fb_counts["fold"],
         "launches_acceptance_config5_sweep": sweep5_counts["fold"],
         **{k: fold_rows[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "onehot_ms")},
         "L4224": {k: fold_rows[1][k] for k in ("max_abs_err", "ms", "plain_ms", "onehot_ms",
                                                 "bound_ms")},
         "reduction_ms": red_ms, "reduction_bound_ms": red_bound[0],
         "launches_depth100_sweep": sweeps31[100]["launches"]["fold"],
         "launches_fused_bench_sweep": rows32["bench_sweep"]["counts_fused"]["fold"],
         "windows_depth100": sweeps31[100]["fold_windows"],
         "reduction_ms_by_depth": {d: v["fold_ms"] for d, v in k2_depth.items()}},
        {"name": "rt_bvh_walk (the integrator's BVH walk, one thread a ray)", "route": "cuda",
         "source": "raytracing_tpu_torch/csrc/bvh_walk.cu",
         "replaces": "raytracing_tpu/ops/traverse.py:179 (the JAX walk's lax.while_loop, "
                     ":133-180; no Pallas kernel)",
         "launches": full26["walk_launches"],
         "path": "bench configuration through hit_method='bvh', fused (phase 26)",
         "launches_cut_render": fused26["walk_launches"][0],
         "launches_auto_render": c23b_counts["walk"],
         "launches_sharded_per_rank": {k: rows30[k]["walk_per_rank"]
                                       for k in ("dp2_bvh", "dp1tp2_bvh")},
         "max_abs_err": walk26["camera"]["max_abs_err"], "ms": walk26["camera"]["kernel_ms"],
         "plain_ms": min(min(v["ms"]) for v in walk26["camera"]["plain_ms_by_check"].values()),
         "bound_ms": walk26["camera"]["bound_ms"], "bound_by": walk26["camera"]["bound_by"],
         "library_ms": None, "B": walk26["camera"]["B"],
         "bounce1": {k: walk26["bounce 1"][k] for k in ("B", "kernel_ms", "bound_ms",
                                                        "bound_by", "brute_ms")},
         "brute_ms": walk26["camera"]["brute_ms"],
         "render_busy_share": full26["busy_share"]},
        {"name": "rt_camera_rays (the gradient replay's camera rays, one thread a ray; "
                 "rt::camera_ray also starts K1's first phase)", "route": "cuda",
         "source": "raytracing_tpu_torch/csrc/camera_rays.cu, csrc/rt_camera.cuh",
         "replaces": "raytracing_tpu/render/camera.py generate_rays (XLA elementwise ops; "
                     "no Pallas kernel)",
         "launches": fb_counts["camera_rays"], "path": "one fwd+bwd bench sweep (phase 6)",
         "launches_fused_bench_sweep": rows32["bench_sweep"]["counts_fused"]["camera_rays"],
         "launches_acceptance_config5_sweep": sweep5_counts["camera_rays"],
         "k1_camera_starts": {"bench_render": render_counts["K1_camera"],
                              "fwd_bwd_sweep": fb_counts["K1_camera"],
                              "fused_bench_render": r32["counts_fused"]["K1_camera"]},
         "bit_equal": all(r["replay_rays_equal"] and r["start_state_equal"] for r in rows34),
         **{k: times34["bouncing_spheres"][k] for k in ("B", "ms", "plain_ms", "bound_ms",
                                                         "bound_by")},
         "library_ms": None, "cornell_box": times34["cornell_box"],
         "k1_first_phase_ms": {k: {"camera": v["k1_camera_ms"], "packed": v["k1_packed_ms"]}
                               for k, v in times34.items()}},
    ]}))
    if failures:
        print(f"chip_smoke: FAILED {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
