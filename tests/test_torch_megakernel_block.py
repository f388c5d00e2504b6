"""K1's plain PyTorch version against the JAX Pallas kernel
(``make_megakernel_block(..., interpret=True)``) on two 1024-ray blocks:
all 14 outputs, at phase offset 0 and at b_off > 0. Then the kernel
source's per-ray math built for the host with g++: both of its searches
(the sweep and the BVH walk) against the plain version, and the walk's
closest hits bit for bit against the sweep's on bench, grazing, tied and
moving-sphere rays, and lanes started from the camera against the same
build fed the packed camera rays.

Bars (tests/test_megakernel.py): radiance max |Δ| < 1e-5 on three_spheres
and cornell_box, mean |Δ| < 2e-3 on bouncing_spheres; segments within
max(4, s/200). The 10 state columns and the bounce counts are held per
ray: a ray agrees when each of them is within 1e-3·max(1, |ref|). XLA on
the CPU contracts multiply-adds into FMAs, which the port (like the TPU)
does not, and a grazing hit amplifies that last-bit difference into a
different path, so a few rays may disagree: at most max(4, n/200) on the
exact scenes, and 5% on bouncing_spheres, whose 488 small spheres graze
often (measured: 0, 3 and ~2.8%).
"""
import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.ops.megakernel import build_mega_scene as jmega
from raytracing_tpu.ops.megakernel_block import make_megakernel_block
from raytracing_tpu.render import camera as jcam
from raytracing_tpu_torch.ops import megakernel_block as mb
from raytracing_tpu_torch.ops.megakernel import build_mega_scene as pmega
from raytracing_tpu_torch.scene.builder import SceneBuilder as PBuilder
from torch_parity import port_scene, segments_close

torch.set_num_threads(2)
B = 2048
DEPTH = 6
SEED = 5
STATE_ROWS = [mb.OX, mb.OY, mb.OZ, mb.DX, mb.DY, mb.DZ, mb.TR, mb.TG, mb.TB, mb.ACT]
CSRC = Path(mb.__file__).resolve().parents[1] / "csrc"


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """Camera rays mid-path: random throughput, some radiance already
    gathered and 10% of the rays dead."""
    scene, cfg = jbuild(name, image_width=32, samples_per_pixel=2, max_depth=DEPTH)
    r = np.random.default_rng(1)
    pix = np.minimum(np.arange(B) % 1024, cfg.n_pixels - 1).astype(np.int32)
    smp = (np.arange(B) // 1024).astype(np.int32)
    params = jcam.CameraParams.from_config(cfg)
    o, d, tm = (np.asarray(x) for x in jcam.generate_rays(
        cfg, jcam.derive(cfg, params), jnp.asarray(pix), jnp.asarray(smp),
        jnp.uint32(SEED), motion_blur=True))
    thr = r.uniform(0.2, 1.0, (3, B)).astype(np.float32)
    rad = np.where(r.random((3, B)) < 0.1, r.random((3, B)), 0.0).astype(np.float32)
    act = (r.random(B) < 0.9).astype(np.float32)
    ray_f = np.stack([*o.T, *d.T, tm, *thr, *rad, act]).astype(np.float32)
    return scene, cfg, ray_f, np.stack([pix, smp])


@functools.lru_cache(maxsize=None)
def _jax_k1_runner(name):
    """The JAX package's K1 for one scene, interpreted and jitted once, so
    both ``b_off`` cases (a runtime argument) share its compilation."""
    scene, cfg, _, _ = _inputs(name)
    mega = jmega(scene)
    run = make_megakernel_block(mega, max_depth=DEPTH, background=cfg.background,
                                interpret=True)
    return jax.jit(lambda *a: run(mega.sph_sweep, mega.quad_sweep, mega.tabt_rep,
                                  mega.noise_rep, mega.atlas_rep, *a))


def _jax_k1(name, ray_f, ray_i, b_off):
    f = [jnp.asarray(x.reshape(-1, 128)) for x in ray_f]
    i = [jnp.asarray(x.reshape(-1, 128)) for x in ray_i]
    out = _jax_k1_runner(name)(*f[:mb.TM + 1], *i, *f[mb.TR:],
                               jnp.asarray([SEED, b_off], jnp.uint32))
    return [np.asarray(x).reshape(-1) for x in out]


@pytest.mark.parametrize("name,b_off", [
    ("three_spheres", 0), ("cornell_box", 0), ("bouncing_spheres", 0),
    ("three_spheres", 3), ("bouncing_spheres", 3),
])
def test_plain_k1_matches_pallas_kernel(name, b_off):
    before_mb = int(mb.launches)
    scene, cfg, ray_f, ray_i = _inputs(name)
    ref = _jax_k1(name, ray_f, ray_i, b_off)
    mega = pmega(port_scene(scene))
    rad, bc, state = mb.trace_block(mega, torch.from_numpy(ray_f), torch.from_numpy(ray_i),
                                    SEED, b_off, max_depth=DEPTH, background=cfg.background)
    assert int(mb.launches) == before_mb  # CPU tensors ran the plain version
    rad, bc, state = rad.numpy(), bc.numpy(), state.numpy()

    diff = np.abs(rad - np.stack(ref[0:3]))
    if name == "bouncing_spheres":
        assert diff.mean() < 2e-3, diff.mean()
    else:
        assert diff.max() < 1e-5, diff.max()
    assert segments_close(ref[3].sum(), bc.sum()), (ref[3].sum(), bc.sum())

    bad = ref[3] != bc
    for k, row in enumerate(STATE_ROWS):
        r_ = ref[4 + k]
        bad |= np.abs(state[row] - r_) > 1e-3 * np.maximum(1.0, np.abs(r_))
    np.testing.assert_array_equal(state[mb.TM], ray_f[mb.TM])
    np.testing.assert_array_equal(state[mb.RR:mb.RB + 1], rad)
    limit = B // 20 if name == "bouncing_spheres" else max(4, B // 200)
    assert bad.sum() <= limit, f"{bad.sum()} rays disagree"


HOST_HARNESS = r"""
#include "megakernel_block.cu"
template <bool M, bool N, bool I, bool C, bool W>
static void run(const TraceParams& p) {
  const float4* s = reinterpret_cast<const float4*>(p.sph);
  const float4* q = reinterpret_cast<const float4*>(p.quad);
  const float4* nd = reinterpret_cast<const float4*>(p.nodes);
  for (int i = 0; i < p.n; ++i) trace_ray<M, N, I, C, W>(p, s, q, nd, p.perm, p.grad, i);
}
template <bool M, bool N, bool I, bool W>
static void run_cap(const TraceParams& p) {
  if (p.dep) run<M, N, I, true, W>(p); else run<M, N, I, false, W>(p);
}
template <bool M, bool W>
static void run_tex(const TraceParams& p, int noise, int image) {
  if (noise) { if (image) run_cap<M, true, true, W>(p); else run_cap<M, true, false, W>(p); }
  else if (image) run_cap<M, false, true, W>(p); else run_cap<M, false, false, W>(p);
}
static TraceParams params(const float* sph, int n_sph_rows, const float* quad,
    int n_quad_rows, const float* table, int n_res_cols, const float* ray_f,
    const int* ray_i, int n, float* out_rad, int* out_bc, float* out_state,
    const int* kid_map, int* out_ids, uint32_t seed, uint32_t b_off, int max_depth,
    int ns_pad, float bg_r, float bg_g, float bg_b, const int* perm, const float* grad,
    const float* atlas, const int* dep, int depth_cap, const float* nodes, int n_nodes,
    const int* sph_gid, int n_sph_chunks, const int* quad_gid, const float* ball) {
  return TraceParams{sph, n_sph_rows, quad, n_quad_rows, table, n_res_cols, ray_f,
                     ray_i, n, out_rad, out_bc, out_state, kid_map, out_ids, seed, b_off,
                     max_depth, ns_pad, bg_r, bg_g, bg_b, perm, grad, atlas, dep, depth_cap,
                     nodes, n_nodes, sph_gid, n_sph_chunks, quad_gid, ball[0], ball[1],
                     ball[2], ball[3], ball[4]};
}
extern "C" void host_trace(const float* sph, int n_sph_rows, const float* quad,
    int n_quad_rows, const float* table, int n_res_cols, const float* ray_f,
    const int* ray_i, int n, float* out_rad, int* out_bc, float* out_state,
    const int* kid_map, int* out_ids, uint32_t seed, uint32_t b_off, int max_depth,
    int ns_pad, float bg_r, float bg_g, float bg_b, int moving, int noise, int image,
    const int* perm, const float* grad, const float* atlas, const int* dep, int depth_cap,
    const float* nodes, int n_nodes, const int* sph_gid, int n_sph_chunks,
    const int* quad_gid, const float* ball, int walk, const float* camera,
    const unsigned char* alive, uint32_t cam_width, int cam_flags) {
  TraceParams p = params(sph, n_sph_rows, quad, n_quad_rows, table, n_res_cols, ray_f,
      ray_i, n, out_rad, out_bc, out_state, kid_map, out_ids, seed, b_off, max_depth, ns_pad,
      bg_r, bg_g, bg_b, perm, grad, atlas, dep, depth_cap, nodes, n_nodes, sph_gid,
      n_sph_chunks, quad_gid, ball);
  p.camera = camera;
  p.alive = alive;
  p.cam_width = cam_width;
  p.cam_flags = cam_flags;
  if (walk) { if (moving) run_tex<true, true>(p, noise, image); else run_tex<false, true>(p, noise, image); }
  else if (moving) run_tex<true, false>(p, noise, image); else run_tex<false, false>(p, noise, image);
}
// One closest hit per ray (rays (7, n): ox oy oz dx dy dz tm) by the sweep
// or the walk: t, the winner's row (ib) and the nodes visited, rows tested
// and wide rays (counts[4], walk only).
extern "C" void host_hit(const float* sph, int n_sph_rows, const float* quad,
    int n_quad_rows, int ns_pad, int moving, const float* nodes, int n_nodes,
    const int* sph_gid, int n_sph_chunks, const int* quad_gid, const float* ball,
    const float* rays, int n, int walk, float* out_t, int* out_ib, long long* counts) {
  const TraceParams p = params(sph, n_sph_rows, quad, n_quad_rows, nullptr, 0, nullptr,
      nullptr, 0, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, ns_pad, 0, 0, 0,
      nullptr, nullptr, nullptr, nullptr, 0, nodes, n_nodes, sph_gid, n_sph_chunks, quad_gid,
      ball);
  const float4* s = reinterpret_cast<const float4*>(sph);
  const float4* q = reinterpret_cast<const float4*>(quad);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  for (int i = 0; i < n; ++i) {
    rt::Ray r;
    r.ox = rays[i]; r.oy = rays[n + i]; r.oz = rays[2 * n + i];
    r.dx = rays[3 * n + i]; r.dy = rays[4 * n + i]; r.dz = rays[5 * n + i];
    r.tm = rays[6 * n + i];
    const HitRay g = hit_ray(r);
    if (walk) {
      if (moving) walk_hit<true>(p, nd, g, out_t[i], out_ib[i], counts);
      else walk_hit<false>(p, nd, g, out_t[i], out_ib[i], counts);
    } else if (moving) sweep_hit<true>(p, s, q, g, out_t[i], out_ib[i]);
    else sweep_hit<false>(p, s, q, g, out_t[i], out_ib[i]);
  }
}
"""


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    """The kernel source's per-ray math (csrc/megakernel_block.cu without
    __CUDACC__) built for the host with a C++ compiler, one ray at a time."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernel's per-ray math")
    d = tmp_path_factory.mktemp("k1host")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libk1host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{CSRC}", str(d / "harness.cpp"), "-o", str(so)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.host_trace.argtypes = [P, I, P, I, P, I, P, P, I, P, P, P, P, P, U, U, I, I, F, F, F,
                               I, I, I, P, P, P, P, I, P, I, P, I, P, P, I, P, P, U, I]
    lib.host_trace.restype = None
    lib.host_hit.argtypes = [P, I, P, I, I, I, P, I, P, I, P, P, P, I, I, P, P, P]
    lib.host_hit.restype = None
    return lib


def _host_trace(lib, mega, f, i, b_off, depth, background, dep=None, depth_cap=None,
                walk=False, camera=None, alive=None):
    """K1's per-ray math built for the host, by the sweep or the walk:
    (rad, bounces, state, ids). ``camera`` (a ``CameraStart``; ``f``
    None) starts the lanes from their camera rays, alive where ``alive``
    is."""
    n = i.shape[1]
    rad = torch.empty(3, n)
    bc = torch.empty(n, dtype=torch.int32)
    state = torch.empty(mb.N_F, n)
    ids = torch.empty(depth, n, dtype=torch.int32)
    ball = torch.tensor(mega.cull_ball, dtype=torch.float32)
    n_sph_rows, n_quad_rows = mega.n_sph, mega.n_quad  # the rows the wrapper passes
    lib.host_trace(
        mega.sph_sweep.data_ptr(), n_sph_rows, mega.quad_sweep.data_ptr(), n_quad_rows,
        mega.table.data_ptr(), mega.n_prims, None if f is None else f.data_ptr(),
        i.data_ptr(), n,
        rad.data_ptr(), bc.data_ptr(), state.data_ptr(), mega.kid_map.data_ptr(),
        ids.data_ptr(), SEED, b_off, depth, mega.n_sph_pad, *background, int(mega.moving),
        int(mega.has_noise), int(mega.has_image), mega.perm.data_ptr(), mega.grad.data_ptr(),
        mega.atlas.data_ptr(), None if dep is None else dep.data_ptr(),
        0 if depth_cap is None else depth_cap, mega.cull_nodes.data_ptr(),
        mega.cull_nodes.shape[0], mega.sph_gid.data_ptr(), mega.n_sph_chunks,
        mega.quad_gid.data_ptr(), ball.data_ptr(), int(walk),
        None if camera is None else camera.camera.data_ptr(),
        None if alive is None else alive.data_ptr(), 0 if camera is None else camera.width,
        0 if camera is None else camera.flags)
    return rad, bc, state, ids


@pytest.mark.parametrize("walk", [False, True], ids=["sweep", "walk"])
@pytest.mark.parametrize("name", ["three_spheres", "cornell_box", "bouncing_spheres",
                                  "perlin_sphere", "earth"])
def test_kernel_source_on_the_host_matches_plain(host_k1, name, walk):
    """The CUDA source's arithmetic, compiled for the CPU without FMA
    contraction, against the plain version: same bars as above, marble at
    the JAX package's mean bar and the image exact (host libm and
    PyTorch may differ by an ulp in sqrt, sin, cos and atan2, and marble's
    floor at octave-7 frequencies turns an ulp of the hit point into
    another lattice cell). The recorded ids agree on every ray whose
    state agrees. The walk's outputs equal the sweep's bit for bit."""
    scene, cfg, ray_f, ray_i = _inputs(name)
    mega = pmega(port_scene(scene))
    f, i = torch.from_numpy(ray_f), torch.from_numpy(ray_i)
    rad, bc, state, ids = _host_trace(host_k1, mega, f, i, 3, DEPTH, cfg.background, walk=walk)
    if walk:
        swept = _host_trace(host_k1, mega, f, i, 3, DEPTH, cfg.background)
        assert all(torch.equal(a, b) for a, b in zip((rad, bc, state, ids), swept))
    ref = mb.trace_block_torch(mega, f, i, SEED, 3, max_depth=DEPTH, background=cfg.background,
                               want_ids=True)
    diff = (rad - ref[0]).abs()
    if name in ("bouncing_spheres", "perlin_sphere"):
        assert diff.mean() < (2e-3 if name == "bouncing_spheres" else 1e-3)
    else:
        assert diff.max() < 1e-5
    assert segments_close(ref[1].sum(), bc.sum())
    rows = STATE_ROWS
    bad = ((state[rows] - ref[2][rows]).abs() > 1e-3 * ref[2][rows].abs().clamp(min=1)).any(0)
    bad |= bc != ref[1]
    assert int(bad.sum()) <= max(4, B // 200)
    assert torch.equal(ids[:, ~bad], ref[3][:, ~bad])


# ---------------------------------------------------------------- the walk's hits

def _host_hits(lib, mega, rays, walk):
    """One closest hit per ray (rays (7, n): ox oy oz dx dy dz tm) from the
    host build of the kernel's sweep or walk: (t, ib, counts), counts the
    walk's nodes visited, sphere and quad rows tested and wide rays."""
    rays = rays.contiguous()  # held: the call reads its memory
    n = rays.shape[1]
    t = torch.empty(n)
    ib = torch.empty(n, dtype=torch.int32)
    counts = torch.zeros(4, dtype=torch.int64)
    ball = torch.tensor(mega.cull_ball, dtype=torch.float32)
    n_sph_rows, n_quad_rows = mega.n_sph, mega.n_quad  # the rows the wrapper passes
    lib.host_hit(mega.sph_sweep.data_ptr(), n_sph_rows, mega.quad_sweep.data_ptr(), n_quad_rows,
                 mega.n_sph_pad, int(mega.moving), mega.cull_nodes.data_ptr(),
                 mega.cull_nodes.shape[0], mega.sph_gid.data_ptr(), mega.n_sph_chunks,
                 mega.quad_gid.data_ptr(), ball.data_ptr(), rays.data_ptr(), n, int(walk),
                 t.data_ptr(), ib.data_ptr(), counts.data_ptr())
    return t, ib.long(), counts


def _sphere_s(mega, rays, sqrt):
    """(n, rows) roots in a·t space of every sphere row, with the plain
    version's arithmetic (inf on a miss), and ta (n,)."""
    ox, oy, oz, dx, dy, dz, tm = (x[:, None] for x in rays)
    a = dx * dx + dy * dy + dz * dz
    ta = T_MIN_F * a
    s_tab = mega.sph_sweep[:mega.n_sph].T
    ocx = (ox - s_tab[0]) - tm * s_tab[3]
    ocy = (oy - s_tab[1]) - tm * s_tab[4]
    ocz = (oz - s_tab[2]) - tm * s_tab[5]
    half_b = ocx * dx + ocy * dy + ocz * dz
    cq = ocx * ocx + ocy * ocy + (ocz * ocz - s_tab[6])
    sq = sqrt(half_b * half_b - a * cq)
    s0, s1 = -half_b - sq, -half_b + sq
    s = torch.where(s0 > ta, s0, s1)
    return torch.where(s > ta, s, torch.inf), ta[:, 0]


def _mirror_scene():
    """Sphere and quad pairs mirrored across x = 0, the +x copy first (the
    lower row) and two far spheres on the x axis, so the BVH's root splits
    along x and the walk meets the higher row of a pair first: a ray in
    the plane x = 0 hits both copies at the same root."""
    b = PBuilder()
    rng = np.random.default_rng(4)
    far = b.lambertian((0.5, 0.5, 0.5))
    b.sphere((50.0, 0.0, 0.0), 0.1, far)
    b.sphere((-50.0, 0.0, 0.0), 0.1, far)
    for k in range(24):
        x, y, z = rng.uniform(0.05, 0.25), rng.uniform(-3, 3), rng.uniform(-3, 3)
        b.sphere((x, y, z), 0.3, b.lambertian((0.1 * (k % 9), 0.5, 0.5)))
        b.sphere((-x, y, z), 0.3, b.lambertian((0.5, 0.1 * (k % 9), 0.5)))
    for k in range(10):
        y, z = rng.uniform(-3, 3), rng.uniform(4, 6)
        b.quad((-0.2, y, z), (0.5, 0.0, 0.0), (0.0, 0.4, 0.0), b.lambertian((0.9, 0.1, 0.1)))
        b.quad((-0.3, y, z), (0.5, 0.0, 0.0), (0.0, 0.4, 0.0), b.lambertian((0.1, 0.9, 0.1)))
    return b.compile(device="cpu")


def _graze_rays(mega, rng, n, tm=None, dist=(0.5, 30.0), off=None):
    """Rays tangent to random spheres to within a few ulps of the radius
    (k·2⁻²³·r, |k| ≤ 8, inside and outside), half of them at the points
    where a sphere touches its bounding box, from ``dist`` units away, with
    |d| in [0.3, 10]; at time ``tm`` (random when None). ``off`` (lo, hi)
    passes them at a uniform lo-hi radii outside the radius instead."""
    sw = mega.sph_sweep[:mega.n_sph].double().numpy()
    rows = rng.integers(0, mega.n_sph, n)
    tm = rng.random(n) if tm is None else np.full(n, float(tm))
    c = sw[rows, 0:3] + tm[:, None] * sw[rows, 3:6]
    r = np.sqrt(sw[rows, 6])
    w = rng.normal(size=(n, 3))
    axis = rng.random(n) < 0.5
    w[axis] = np.eye(3)[rng.integers(0, 3, int(axis.sum()))] * rng.choice([-1.0, 1.0],
                                                                              (int(axis.sum()), 1))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    u = np.cross(w, rng.normal(size=(n, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    k = rng.integers(-8, 9, n) * 2.0 ** -23 if off is None else rng.uniform(*off, n)
    p = c + (r * (1.0 + k))[:, None] * w
    o = p - rng.uniform(*dist, n)[:, None] * u
    d = u * rng.uniform(0.3, 10.0, n)[:, None]
    return torch.from_numpy(np.ascontiguousarray(np.concatenate([o.T, d.T, tm[None]]),
                                                 np.float32))


@functools.lru_cache(maxsize=None)
def _hit_case(case):
    """(mega, rays (7, n)) of one case of the walk's tests."""
    rng = np.random.default_rng(8)
    if case == "ties":
        mega = pmega(_mirror_scene())
        n = 1024
        o = np.stack([np.zeros(n), rng.uniform(-3, 3, n), np.full(n, -10.0)])
        d = np.stack([np.zeros(n), rng.uniform(-0.1, 0.1, n), np.ones(n)])
        rays = np.concatenate([o, d, np.zeros((1, n))]).astype(np.float32)
        return mega, torch.cat([torch.from_numpy(rays), _graze_rays(mega, rng, 512)], 1)
    name = "cornell_box" if case == "cornell_box" else "bouncing_spheres"
    scene, cfg, ray_f, ray_i = _inputs(name)
    mega = pmega(port_scene(scene))
    f = torch.from_numpy(ray_f)
    # camera rays and the mid-path rays after two bounces (origins on surfaces)
    mid = mb.trace_block_torch(mega, f, torch.from_numpy(ray_i), SEED, 0, max_depth=2,
                               background=cfg.background)[2]
    rays = torch.cat([f[mb.OX:mb.TM + 1], mid[mb.OX:mb.TM + 1, mid[mb.ACT] > 0]], 1)
    if case.startswith("moving"):
        tm = float(case[-1])
        rays[mb.TM] = tm
        return mega, torch.cat([rays, _graze_rays(mega, rng, 1024, tm)], 1)
    if case == "graze":
        return mega, _graze_rays(mega, rng, 4096)
    if case == "far":  # 1,000-2,000 radii out, in the rounding band of the 0.2 spheres
        return mega, _graze_rays(mega, rng, 4096, dist=(200.0, 400.0), off=(0.0, 1.5))
    return mega, rays


@pytest.mark.parametrize("case", ["bench", "graze", "far", "ties", "moving_t0", "moving_t1",
                                  "cornell_box"])
def test_walk_hits_equal_the_sweep(host_k1, case, monkeypatch):
    """K1's walk, built for the host from the kernel source, finds the
    sweep's winner, t and id on every ray, bit for bit: against the host
    build of the sweep, and against the plain version with correctly
    rounded square roots (as CUDA's; PyTorch's vectorized CPU sqrt is off
    by an ulp on ~0.6% of inputs). Cases: bench camera and mid-path rays,
    rays grazing spheres a few ulps off tangent, rays from 1,000-2,000
    radii away passing in the discriminant's rounding band (outside the
    cull ball: the walk widens its boxes), exact ties between mirrored
    spheres and quads (the walk meets the higher row first), the moving
    spheres at times 0 and 1, and the quads of cornell_box. The walk tests
    fewer rows than the sweep."""
    mega, rays = _hit_case(case)
    t_s, ib_s, _ = _host_hits(host_k1, mega, rays, walk=False)
    t_w, ib_w, counts = _host_hits(host_k1, mega, rays, walk=True)
    sqrt = torch.sqrt

    def sqrt_rn(x):
        return sqrt(x.double()).float()

    monkeypatch.setattr(torch, "sqrt", sqrt_rn)
    t_p, ib_p = mb._closest_hit(mega, *rays)
    monkeypatch.undo()
    assert torch.equal(ib_w, ib_s) and torch.equal(t_w, t_s)
    assert torch.equal(ib_w, ib_p) and torch.equal(t_w, t_p)
    hit = ib_p >= 0
    assert torch.equal(mega.kid_map[ib_w[hit]], mega.kid_map[ib_p[hit]])
    assert 0.2 < float(hit.float().mean())
    n = rays.shape[1]
    if mega.n_sph:  # each sphere winner's t is its root s over a
        s_all, ta = _sphere_s(mega, rays, sqrt_rn)
        sph = hit & (ib_p < mega.n_sph_pad)
        s_win = s_all[sph, ib_p[sph]]
        a = rays[3] * rays[3] + rays[4] * rays[4] + rays[5] * rays[5]
        assert torch.equal(s_win * (1.0 / a[sph]), t_w[sph])
        if case == "ties":  # rays whose nearest root two rows share
            ties = (s_all[sph] == s_win[:, None]).sum(1) > 1
            assert int(ties.sum()) > 50
        if case == "bench":
            assert int(counts[1]) < 0.25 * n * mega.n_sph
        if case == "far":
            assert int(counts[3]) > 0.9 * n


T_MIN_F = mb.T_MIN


def _pool_rays(name):
    """Mid-path rays as the pool holds them: each with its own depth
    ``dep`` in [0, 6) before this launch."""
    scene, cfg, ray_f, ray_i = _inputs(name)
    dep = np.random.default_rng(2).integers(0, 6, B).astype(np.int32)
    return scene, cfg, torch.from_numpy(ray_f), torch.from_numpy(ray_i), torch.from_numpy(dep)


@pytest.mark.parametrize("walk", [False, True], ids=["sweep", "walk"])
def test_kernel_source_on_the_host_depth_cap(host_k1, walk):
    """A pool-shaped launch (per-ray depth, cap 6, 3 bounces) through the
    host build of the kernel source equals the plain version, and no ray
    traces past the cap, by either search."""
    scene, cfg, f, i, dep = _pool_rays("cornell_box")
    mega = pmega(port_scene(scene))
    rad, bc, state, _ = _host_trace(host_k1, mega, f, i, 0, 3, cfg.background, dep, 6,
                                    walk=walk)
    ref = mb.trace_block_torch(mega, f, i, SEED, 0, max_depth=3, background=cfg.background,
                               depth_cap=6, dep=dep)
    assert (rad - ref[0]).abs().max() < 1e-5
    assert torch.equal(bc, ref[1])
    assert torch.equal(state[mb.ACT], ref[2][mb.ACT])
    assert bool((dep + bc <= 6).all()) and bool(((dep + bc == 6) & (bc > 0)).any())


@pytest.mark.parametrize("walk", [False, True], ids=["sweep", "walk"])
def test_kernel_source_on_the_host_starts_from_the_camera(host_k1, walk):
    """Lanes started from the camera (``TraceParams::camera``) through the
    host build of the kernel source equal the same build fed the packed
    camera rays, bit for bit, at depth 0 (the start state itself) and
    DEPTH: cornell_box (no defocus, so the host's rays are
    ``generate_rays``' own) at 30 px, its last 124 lanes clamped and
    dead, samples 1 and 2 of 2 spp."""
    from raytracing_tpu_torch import build as pbuild
    from raytracing_tpu_torch.render import camera as pcam
    from raytracing_tpu_torch.render.renderer import chunk_ids

    scene, cfg = pbuild("cornell_box", device="cpu", image_width=30, samples_per_pixel=2,
                        max_depth=DEPTH)
    mega = pmega(scene)
    start = pcam.CameraStart.of(cfg, pcam.pack_camera(pcam.derive(
        cfg, pcam.CameraParams.from_config(cfg, "cpu"))), motion_blur=True)
    pix, smp, _, alive = chunk_ids(cfg, 0, 1, n_block=1024, spp_chunk=2, device="cpu")
    f, i = mb.pack_rays(*start.rays(pix, smp, SEED), pix, smp, alive)
    assert 0 < int(alive.sum()) < alive.numel()
    for depth in (0, DEPTH):
        cam = _host_trace(host_k1, mega, None, i, 0, depth, cfg.background, walk=walk,
                          camera=start, alive=alive)
        ref = _host_trace(host_k1, mega, f, i, 0, depth, cfg.background, walk=walk)
        assert all(torch.equal(a, b) for a, b in zip(cam, ref)), depth
        if depth == 0:  # the start: alive as flagged, unit throughput, no radiance
            assert torch.equal(cam[2][mb.ACT] > 0, alive)
            assert bool((cam[2][mb.TR:mb.TB + 1] == 1).all() and (cam[0] == 0).all())
    assert int(cam[1].sum()) > 0


def test_depth_cap_continues_the_rng_stream():
    """A ray at depth ``dep`` draws what the phased trace draws at phase
    offset ``dep``: with a cap no ray reaches, the pool's launch equals the
    uncapped one at ``b_off = dep`` bit for bit; with the cap, a ray dies
    after its segment ``depth_cap`` with its state kept."""
    scene, cfg, f, i, _ = _pool_rays("three_spheres")
    mega = pmega(port_scene(scene))
    kw = dict(max_depth=3, background=cfg.background)
    dep = torch.full((B,), 2, dtype=torch.int32)
    capped = mb.trace_block(mega, f, i, SEED, 0, depth_cap=100, dep=dep, **kw)
    shifted = mb.trace_block(mega, f, i, SEED, 2, **kw)
    assert all(torch.equal(a, b) for a, b in zip(capped, shifted))
    rad, bc, state = mb.trace_block(mega, f, i, SEED, 0, depth_cap=3, dep=dep, **kw)
    one = mb.trace_block(mega, f, i, SEED, 2, **{**kw, "max_depth": 1})
    assert int(bc.max()) == 1 and torch.equal(rad, one[0])
    assert int((one[2][mb.ACT] > 0).sum()) > B // 2  # rays the cap stopped from scattering
    assert not bool(state[mb.ACT].any())
    assert torch.equal(state[mb.OX:mb.TB + 1], f[mb.OX:mb.TB + 1])


def test_phase_offset_feeds_the_rng():
    """b_off changes every scatter draw: the same rays trace other paths."""
    scene, cfg, ray_f, ray_i = _inputs("three_spheres")
    mega = pmega(port_scene(scene))
    args = (mega, torch.from_numpy(ray_f), torch.from_numpy(ray_i), SEED)
    kw = dict(max_depth=DEPTH, background=cfg.background)
    s0 = mb.trace_block(*args, 0, **kw)[2]
    s3 = mb.trace_block(*args, 3, **kw)[2]
    alive = ray_f[mb.ACT] > 0
    assert (s0[mb.DX].numpy() != s3[mb.DX].numpy())[alive].mean() > 0.5


def test_wrapper_refuses_what_k1_does_not_port():
    """want_ids is a fourth output; ``depth_cap`` and ``dep`` come together
    or not at all, and bad shapes or types are refused; a noise scene runs
    (the plain version on CPU tensors)."""
    before_mb = int(mb.launches)
    scene, cfg, ray_f, ray_i = _inputs("three_spheres")
    mega = pmega(port_scene(scene))
    f, i = torch.from_numpy(ray_f), torch.from_numpy(ray_i)
    kw = dict(max_depth=2, background=cfg.background)
    *_, ids = mb.trace_block(mega, f, i, 0, 0, want_ids=True, **kw)
    assert ids.shape == (2, B) and ids.dtype == torch.int32
    dep = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="dep exactly"):
        mb.trace_block(mega, f, i, 0, 0, depth_cap=4, **kw)
    with pytest.raises(ValueError, match="dep exactly"):
        mb.trace_block(mega, f, i, 0, 0, dep=dep, **kw)
    with pytest.raises(ValueError):
        mb.trace_block(mega, f, i, 0, 0, depth_cap=4, dep=dep.long(), **kw)
    with pytest.raises(ValueError):
        mb.trace_block(mega, f[:, :5], i, 0, 0, **kw)
    with pytest.raises(ValueError):
        mb.trace_block(mega, f, i.to(torch.int64), 0, 0, **kw)
    scene_n, cfg_n, f_n, i_n = _inputs("perlin_sphere")
    mega_n = pmega(port_scene(scene_n))
    assert mega_n.has_noise
    rad, bc, _ = mb.trace_block(mega_n, torch.from_numpy(f_n), torch.from_numpy(i_n), 0, 0,
                                **{**kw, "background": cfg_n.background})
    assert bool(torch.isfinite(rad).all()) and int(bc.sum()) > 0 and int(mb.launches) == before_mb
