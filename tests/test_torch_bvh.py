"""The large-scene path of the port against the JAX package: the chunked
BVH build, K5's plain walk and dense sweep, and the Renderer on a scene of
about 4,100 spheres, with no Pallas kernel run (the JAX side is its host
BVH build and the XLA integrator over ``ops/traverse.closest_hit_bvh``).

Bars: the BVH tables equal the JAX tables exactly; the walk and the sweep
give bit-identical radiance and segments (the JAX package's own bar,
tests/test_megakernel.py TestInKernelBVH); against the XLA traversal,
radiance mean |Δ| < 2e-3 and segments within max(4, s/200), as there. A
g++ build of csrc/megakernel_group.cu's closest hit is bit-equal to the
plain version's, visit counts included.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.ops import mega_bvh as jbvh
from raytracing_tpu.ops.traverse import closest_hit_bvh
from raytracing_tpu.render import camera as jcam
from raytracing_tpu.render.camera import CameraConfig as JCameraConfig
from raytracing_tpu.render.integrator import trace as jtrace
from raytracing_tpu.render.renderer import Renderer as JRenderer
from raytracing_tpu.scene import flatten as jfl
from raytracing_tpu.scene.builder import SceneBuilder as JSceneBuilder
from raytracing_tpu_torch import Renderer
from raytracing_tpu_torch.ops import mega_bvh as pbvh
from raytracing_tpu_torch.ops import megakernel_block as mb
from raytracing_tpu_torch.ops import megakernel_group as mg
from raytracing_tpu_torch.ops.megakernel import build_mega_scene as pmega
from raytracing_tpu_torch.ops.megakernel import select_layout, trace_megakernel
from raytracing_tpu_torch.render.camera import CameraConfig
from raytracing_tpu_torch.scene.builder import SceneBuilder
from torch_parity import (K5_EDGE_CASES, bouncing_spheres_64, bouncing_spheres_64_config,
                          k5_edge_case, mixed_scene, mixed_scene_config, port_scene,
                          segments_close)

torch.set_num_threads(2)
B = 1024
SEED = 3
CSRC = Path(mg.__file__).resolve().parents[1] / "csrc"


def _jax_scene(name):
    """(JAX scene, JAX CameraConfig) at the reference tests' small shapes."""
    kw = dict(image_width=32, samples_per_pixel=1)
    if name == "mixed":
        return mixed_scene(JSceneBuilder()).compile(), mixed_scene_config(JCameraConfig)
    if name == "bouncing_spheres_64":
        return (bouncing_spheres_64(JSceneBuilder()).compile(),
                bouncing_spheres_64_config(JCameraConfig, **kw))
    return jbuild(name, **kw)


def _rays(scene, cfg, seed=SEED):
    """One 1024-ray block of camera rays, as JAX arrays and CPU tensors."""
    pix = jnp.minimum(jnp.arange(B, dtype=jnp.int32), cfg.n_pixels - 1)
    smp = jnp.zeros(B, jnp.int32)
    o, d, t = jcam.generate_rays(cfg, jcam.derive(cfg, jcam.CameraParams.from_config(cfg)),
                                 pix, smp, jnp.uint32(seed), motion_blur=scene.flags.has_moving)
    jr = (o, d, t, pix, smp)
    return jr, [torch.from_numpy(np.array(x)) for x in jr]


@pytest.mark.parametrize("name", ["bouncing_spheres", "cornell_box", "mixed",
                                  "bouncing_spheres_64"])
def test_bvh_tables_equal_jax(name):
    """Both builders on the JAX unified table: the port's rows are the JAX
    columns with the 128-lane padding cut off."""
    sj, _ = _jax_scene(name)
    table, ns_pad, nq, _ = jfl.unified_table(sj, chunk=8)
    table = np.asarray(table)
    n_sph = int(np.count_nonzero(table[jfl.U_G6, :ns_pad] > 0))
    ref = jbvh.build_chunked_bvh(table, ns_pad, n_sph, nq)
    out = pbvh.build_chunked_bvh(table, ns_pad, n_sph, nq)
    assert (out.n_nodes, out.n_sph_chunks, out.n_quad_chunks, out.depth_max) == (
        ref.n_nodes, ref.n_sph_chunks, ref.n_quad_chunks, ref.depth_max)
    np.testing.assert_array_equal(out.nodes, ref.node_tab[:, :ref.n_nodes].T)
    # JAX leaf rows are field-major: row f * 8 + member, one chunk per column
    sph = ref.sph_leaf_tab.reshape(jbvh.SPH_LEAF_FIELDS, 8, -1).transpose(2, 1, 0)
    sph = sph[:ref.n_sph_chunks]
    np.testing.assert_array_equal(out.sph_leaf[..., :7], sph[..., :7])
    np.testing.assert_array_equal(out.sph_leaf[..., 7], 0.0)
    np.testing.assert_array_equal(out.sph_gid, sph[..., 7].astype(np.int32))
    quad = ref.quad_leaf_tab.reshape(jbvh.QUAD_LEAF_FIELDS, 8, -1).transpose(2, 1, 0)
    quad = quad[:ref.n_quad_chunks]
    np.testing.assert_array_equal(out.quad_leaf[..., :7], quad[..., :7])
    np.testing.assert_array_equal(out.quad_leaf[..., 7:], quad[..., 8:17])
    np.testing.assert_array_equal(out.quad_gid, quad[..., 7].astype(np.int32))
    if name == "mixed":
        assert out.n_sph_chunks > 0 and out.n_quad_chunks > 0


@pytest.mark.parametrize("name,depth", [("bouncing_spheres", 8), ("cornell_box", 5),
                                        ("mixed", 6)])
def test_plain_walk_bitmatches_plain_sweep(name, depth):
    before_mg = int(mg.launches)
    sj, cfg = _jax_scene(name)
    _, rays = _rays(sj, cfg)
    mega = pmega(port_scene(sj))
    args = (mega, *rays, cfg.background, depth, SEED)
    r_walk, s_walk = trace_megakernel(*args, layout="group", use_bvh=True)
    r_sweep, s_sweep = trace_megakernel(*args, layout="group", use_bvh=False)
    assert int(mg.launches) == before_mg  # CPU tensors ran the plain version
    assert torch.equal(r_walk, r_sweep)
    assert int(s_walk) == int(s_sweep)
    assert float(r_walk.sum()) > 0


def test_plain_walk_matches_xla_traversal():
    sj, cfg = _jax_scene("bouncing_spheres")
    jr, rays = _rays(sj, cfg)
    mega = pmega(port_scene(sj))
    r_p, s_p = trace_megakernel(mega, *rays, cfg.background, 6, SEED, layout="group",
                                use_bvh=True)
    r_j, s_j = jtrace(sj, *jr, jnp.asarray(cfg.background), 6, jnp.uint32(SEED),
                      hit_fn=closest_hit_bvh)
    diff = np.abs(r_p.numpy() - np.asarray(r_j))
    assert diff.mean() < 2e-3, diff.mean()
    assert segments_close(s_j, s_p), (int(s_j), int(s_p))


def test_renderer_selects_group_layout_on_large_scene(monkeypatch):
    """A scene above 2,048 primitives renders through K5's walk with no
    argument, and matches the XLA integrator over the BVH traversal. 64 px
    wide (2,304 paths): XLA's FMA contraction turns ~0.5% of this dense
    scene's paths, and one diverging path of the 144 at 16 px moves the
    mean |Δ| by ~1e-3 alone."""
    kw = dict(image_width=64, samples_per_pixel=1, max_depth=4)
    sj = bouncing_spheres_64(JSceneBuilder()).compile()
    cfg_j = bouncing_spheres_64_config(JCameraConfig, **kw)
    scene = bouncing_spheres_64(SceneBuilder()).compile(device="cpu")
    cfg = bouncing_spheres_64_config(CameraConfig, **kw)
    mega = pmega(scene)
    assert mega.n_prims // 8 > 256
    assert select_layout(mega) == ("group", True)
    calls = []
    real = mg.trace_group

    def counted(*a, **k):
        calls.append(k["use_bvh"])
        return real(*a, **k)

    monkeypatch.setattr(mg, "trace_group", counted)
    r = Renderer(cfg, phase_depths=[2, 2])
    out = r.render(scene, seed=SEED)
    assert calls == [True, True] * out.launches
    with pytest.raises(ValueError, match="block layout"):
        r.plan_phase_prefixes(scene, seed=SEED)
    ref = JRenderer(cfg_j, hit_method="bvh", mode="while").render(sj, seed=SEED)
    assert np.abs(out.radiance - np.asarray(ref.radiance)).mean() < 2e-3
    assert segments_close(ref.segments, out.segments), (ref.segments, out.segments)


def test_layout_selection_and_refusals():
    before_mg = int(mg.launches)
    sj, cfg = _jax_scene("three_spheres")
    mega = pmega(port_scene(sj))
    _, rays = _rays(sj, cfg)
    assert select_layout(mega) == ("block", False)
    assert select_layout(mega, use_bvh=True) == ("group", True)
    assert select_layout(mega, layout="group") == ("group", False)
    with pytest.raises(ValueError, match="no BVH walk"):
        select_layout(mega, layout="block", use_bvh=True)
    for kw in (dict(want_ids=True), dict(want_counts=True),
               dict(phase_depths=[1, 1], phase_prefixes=[None, 1024])):
        with pytest.raises(ValueError, match="block layout"):
            trace_megakernel(mega, *rays, cfg.background, 2, SEED, use_bvh=True, **kw)
    ray_f = torch.zeros((mb.N_F, 8))
    ray_i = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        mg.trace_group(mega, ray_f, ray_i.long(), 0, 0, max_depth=1, background=(0, 0, 0),
                       use_bvh=True)
    # K5 shades marble noise, as K1's plain version does
    sn, cfg_n = _jax_scene("perlin_sphere")
    mega_n = pmega(port_scene(sn))
    _, rays_n = _rays(sn, cfg_n)
    args = (mega_n, *rays_n, cfg_n.background, 3, SEED)
    r5, s5 = trace_megakernel(*args, layout="group", use_bvh=True)
    r1, s1 = trace_megakernel(*args, layout="block")
    assert mega_n.has_noise and int(mg.launches) == before_mg
    assert float((r5 - r1).abs().mean()) < 1e-3 and segments_close(int(s1), int(s5))


HOST_HARNESS = r"""
#include "megakernel_group.cu"
static GroupParams params(const float* table, int P, int ns_pad, const float* nodes,
    int n_nodes, const float* sph_leaf, const int* sph_gid, int n_sph_chunks,
    const float* quad_leaf, const int* quad_gid, const float* ray_f, const int* ray_i,
    int n, float* out_rad, int* out_bc, float* out_state, uint32_t seed, uint32_t b_off,
    int max_depth, float bg_r, float bg_g, float bg_b, const int* perm, const float* grad,
    const float* atlas) {
  return GroupParams{table, P, ns_pad, nodes, n_nodes, sph_leaf, sph_gid, n_sph_chunks,
                     quad_leaf, quad_gid, ray_f, ray_i, n, out_rad, out_bc, out_state, seed,
                     b_off, max_depth, bg_r, bg_g, bg_b, perm, grad, atlas};
}
template <bool N, bool I>
static void run(const GroupParams& p, int use_bvh) {
  const float4* nd = reinterpret_cast<const float4*>(p.nodes);
  for (int i = 0; i < p.n; ++i) {
    if (use_bvh) trace_ray_group<true, N, I>(p, nd, i); else trace_ray_group<false, N, I>(p, nd, i);
  }
}
// closest hit of every ray's first segment; counts (3, n) with the walk;
// design 0: the baseline design, else K5Design
extern "C" void host_hit(const float* table, int P, int ns_pad, const float* nodes,
    int n_nodes, const float* sph_leaf, const int* sph_gid, int n_sph_chunks,
    const float* quad_leaf, const int* quad_gid, const float* ray_f, const int* ray_i,
    int n, int use_bvh, int design, float* out_t, int* out_ib, long long* counts) {
  GroupParams p = params(table, P, ns_pad, nodes, n_nodes, sph_leaf, sph_gid, n_sph_chunks,
                         quad_leaf, quad_gid, ray_f, ray_i, n, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                         0, 0);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  for (int i = 0; i < n; ++i) {
    rt::Ray r = rt::load_ray(ray_f, ray_i, n, i);
    long long c[N_COUNTS] = {0, 0, 0, 0, 0, 0, 0};
    if (use_bvh && design) walk_hit<K5Design>(p, nd, r, out_t[i], out_ib[i], c);
    else if (use_bvh) walk_hit<BaselineDesign>(p, nd, r, out_t[i], out_ib[i], c);
    else if (design) sweep_hit<K5Design>(p, r, out_t[i], out_ib[i]);
    else sweep_hit<BaselineDesign>(p, r, out_t[i], out_ib[i]);
    for (int k = 0; k < 3; ++k) counts[k * n + i] = c[k];
  }
}
extern "C" void host_trace(const float* table, int P, int ns_pad, const float* nodes,
    int n_nodes, const float* sph_leaf, const int* sph_gid, int n_sph_chunks,
    const float* quad_leaf, const int* quad_gid, const float* ray_f, const int* ray_i,
    int n, float* out_rad, int* out_bc, float* out_state, uint32_t seed, uint32_t b_off,
    int max_depth, float bg_r, float bg_g, float bg_b, int use_bvh, int noise, int image,
    const int* perm, const float* grad, const float* atlas) {
  GroupParams p = params(table, P, ns_pad, nodes, n_nodes, sph_leaf, sph_gid, n_sph_chunks,
                         quad_leaf, quad_gid, ray_f, ray_i, n, out_rad, out_bc, out_state,
                         seed, b_off, max_depth, bg_r, bg_g, bg_b, perm, grad, atlas);
  if (noise) { if (image) run<true, true>(p, use_bvh); else run<true, false>(p, use_bvh); }
  else if (image) run<false, true>(p, use_bvh); else run<false, false>(p, use_bvh);
}
"""


@pytest.fixture(scope="module")
def host_k5(tmp_path_factory):
    """The kernel source's per-ray math (csrc/megakernel_group.cu without
    __CUDACC__) built for the host with a C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernel's per-ray math")
    d = tmp_path_factory.mktemp("k5host")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libk5host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{CSRC}", str(d / "harness.cpp"), "-o", str(so)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    tables = [P, I, I, P, I, P, P, I, P, P, P, P, I]
    lib.host_hit.argtypes = tables + [I, I, P, P, P]
    lib.host_hit.restype = None
    lib.host_trace.argtypes = tables + [P, P, P, U, U, I, F, F, F, I, I, I, P, P, P]
    lib.host_trace.restype = None
    return lib


def _mid_path_rays(sj, cfg):
    """Camera rays with random throughput, some radiance gathered and 10%
    of the rays dead."""
    _, (o, d, t, pix, smp) = _rays(sj, cfg)
    r = np.random.default_rng(1)
    thr = torch.from_numpy(r.uniform(0.2, 1.0, (3, B)).astype(np.float32))
    rad = torch.from_numpy(np.where(r.random((3, B)) < 0.1, r.random((3, B)), 0.0)
                           .astype(np.float32))
    act = torch.from_numpy((r.random(B) < 0.9).astype(np.float32))
    ray_f = torch.cat([o.T, d.T, t[None], thr, rad, act[None]]).contiguous()
    return ray_f, torch.stack([pix, smp]).contiguous()


def _table_args(mega, ray_f, ray_i):
    return (mega.table.data_ptr(), mega.n_prims, mega.n_sph_pad, mega.nodes.data_ptr(),
            mega.nodes.shape[0], mega.sph_leaf.data_ptr(), mega.sph_gid.data_ptr(),
            mega.n_sph_chunks, mega.quad_leaf.data_ptr(), mega.quad_gid.data_ptr(),
            ray_f.data_ptr(), ray_i.data_ptr(), ray_f.shape[1])


@pytest.mark.parametrize("name", ["bouncing_spheres", "mixed", "simple_light", "earth"])
def test_kernel_source_on_the_host_matches_plain(host_k5, name):
    """The closest hit of the walk and of the sweep, compiled for the CPU
    without FMA contraction, is bit-equal to the plain version's, node
    visits and member tests included. A whole phase agrees within K1's
    bars (tests/test_torch_megakernel_block.py: host libm and PyTorch may
    differ by an ulp in sin, cos and atan2), marble at the JAX package's
    mean bar and the image exact."""
    sj, cfg = _jax_scene(name)
    mega = pmega(port_scene(sj))
    ray_f, ray_i = _mid_path_rays(sj, cfg)
    args = _table_args(mega, ray_f, ray_i)
    geo = ray_f[mb.OX:mb.TM + 1]
    alive = torch.ones(B, dtype=torch.bool)
    for use_bvh in (True, False):
        t = torch.empty(B)
        ib = torch.empty(B, dtype=torch.int32)
        counts = torch.zeros((3, B), dtype=torch.int64)
        host_k5.host_hit(*args, int(use_bvh), 1, t.data_ptr(), ib.data_ptr(),
                         counts.data_ptr())
        if use_bvh:
            ref_counts = torch.zeros((3, B), dtype=torch.int64)
            t_ref, ib_ref = mg._walk(mega, *geo, alive, ref_counts)
            assert torch.equal(counts, ref_counts)
            assert int(counts[0].min()) > 0
        else:
            t_ref, ib_ref = mg._sweep(mega, *geo)
        assert torch.equal(t, t_ref)
        assert torch.equal(ib.long(), ib_ref)
        # the globe fills a fifth of its frame; the other scenes more than half
        assert int((ib >= 0).sum()) > (B // 8 if name == "earth" else B // 2)

    rad = torch.empty(3, B)
    bc = torch.empty(B, dtype=torch.int32)
    state = torch.empty(mb.N_F, B)
    host_k5.host_trace(*args, rad.data_ptr(), bc.data_ptr(), state.data_ptr(), SEED, 2, 6,
                       *cfg.background, 1, int(mega.has_noise), int(mega.has_image),
                       mega.perm.data_ptr(), mega.grad.data_ptr(), mega.atlas.data_ptr())
    ref = mg.trace_group_torch(mega, ray_f, ray_i, SEED, 2, max_depth=6,
                               background=cfg.background, use_bvh=True)
    diff = (rad - ref[0]).abs()
    if name == "earth":
        assert diff.max() < 1e-5
    else:
        assert diff.mean() < (1e-3 if name == "simple_light" else 2e-3)
    assert segments_close(ref[1].sum(), bc.sum())
    bad = ((state - ref[2]).abs() > 1e-3 * ref[2].abs().clamp(min=1)).any(0) | (bc != ref[1])
    assert int(bad.sum()) <= max(4, B // 200)


@pytest.mark.parametrize("case", K5_EDGE_CASES)
def test_kernel_source_edge_cases_match_plain(host_k5, case):
    """The kernel's closest hit at the edges of its member test (a
    discriminant of exactly 0, negative ones, leaves with pad slots, equal
    roots in two leaves), compiled for the CPU: K5's design and the baseline
    design (unguarded root, one loop) are each bit-equal to the plain walk
    and sweep, and count the plain version's box tests and real member
    tests (pad slots are tested, not counted). With one bounce, the plain
    version's trace_group_torch counts the same tests."""
    mega, ray_f, ray_i = k5_edge_case(case)
    n = ray_f.shape[1]
    args = _table_args(mega, ray_f, ray_i)
    geo = ray_f[mb.OX:mb.TM + 1]
    plain_counts = torch.zeros((3, n), dtype=torch.int64)
    ref = {True: mg._walk(mega, *geo, torch.ones(n, dtype=torch.bool), plain_counts),
           False: mg._sweep(mega, *geo)}
    for use_bvh in (True, False):
        for design in (1, 0):
            t = torch.empty(n)
            ib = torch.empty(n, dtype=torch.int32)
            counts = torch.zeros((3, n), dtype=torch.int64)
            host_k5.host_hit(*args, int(use_bvh), design, t.data_ptr(), ib.data_ptr(),
                             counts.data_ptr())
            assert torch.equal(t, ref[use_bvh][0]) and torch.equal(ib.long(), ref[use_bvh][1])
            if use_bvh:
                assert torch.equal(counts, plain_counts)
    hits = int((ref[True][1] >= 0).sum())
    assert hits == 0 if case == "negative_disc" else hits > 0
    if case == "short_chunk":  # every leaf has pad slots, which are not counted
        assert bool((mg.real_members(mega.sph_gid) < 8).all())
        assert int(plain_counts[1].sum()) < 8 * int((plain_counts[1] > 0).sum())
    one = mg.trace_group_torch(mega, ray_f, ray_i, SEED, 0, max_depth=1,
                               background=(0.7, 0.8, 1.0), use_bvh=True, want_counts=True)
    assert torch.equal(one[3], plain_counts)
