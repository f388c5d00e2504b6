"""The Next Week's final scene (``next_week_final``) on the CPU: the
benchmark's recipe against the port's registry, the port's render against
the plain reference (``benchmark/reference/final.py``), K1's media (the
plain version and the kernel source's per-ray math built for the host
with g++) on their edge cases, the reference's culled search against
brute force, the lower-precision control against the cell's limits, and
the paths that refuse media. On a card (``-m cuda``): K1's MEDIUM
instantiation against its plain version at the cell's launch shape.

The reference renders of this file pass ``max-abs < 1e-5`` with equal
segments and medium scatters; measured, they agree bit for bit.
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.common import compare  # noqa: E402
from benchmark.reference import final, tracer  # noqa: E402
from raytracing_tpu_torch import Renderer  # noqa: E402
from raytracing_tpu_torch.models.scenes import build  # noqa: E402
from raytracing_tpu_torch.ops import megakernel_block as mb  # noqa: E402
from raytracing_tpu_torch.ops.megakernel import build_mega_scene  # noqa: E402
from raytracing_tpu_torch.scene.builder import SceneBuilder  # noqa: E402

CONFIG = ROOT / "benchmark" / "configs" / "next_week_final.json"
CSRC = Path(mb.__file__).resolve().parents[1] / "csrc"
# a camera in front of the blue medium, so that paths random-walk in it
NEAR_BLUE = dict(lookfrom=(360.0, 150.0, 30.0), lookat=(360.0, 150.0, 145.0))


@pytest.fixture(scope="module")
def recipe():
    return final.load_config(CONFIG)


def test_recipe_tables_equal_the_port_registry(recipe):
    conf, arr = recipe
    scene, cfg = build(conf["port_scene"], device="cpu")
    ns, nq, nm = len(arr["sph_radius"]), len(arr["quad_mat"]), len(arr["med_radius"])
    assert conf["primitives"] == {"spheres": ns, "quads": nq, "media": nm} == {
        "spheres": 1006, "quads": 2401, "media": scene.n_media}
    pairs = [(scene.spheres.center[:ns], arr["sph_center"]),
             (scene.spheres.velocity[:ns], arr["sph_velocity"]),
             (scene.spheres.radius[:ns], arr["sph_radius"]),
             (scene.spheres.mat_id[:ns], arr["sph_mat"]),
             (scene.quads.q[:nq], arr["quad_q"]), (scene.quads.u[:nq], arr["quad_u"]),
             (scene.quads.v[:nq], arr["quad_v"]), (scene.quads.mat_id[:nq], arr["quad_mat"]),
             (scene.materials.mtype, arr["mat_type"]), (scene.materials.tex_id, arr["mat_tex"]),
             (scene.materials.fuzz, arr["mat_fuzz"]), (scene.materials.ior, arr["mat_ior"]),
             (scene.textures.ttype, arr["tex_type"]), (scene.textures.rgb, arr["tex_rgb"]),
             (scene.textures.scale, arr["tex_scale"]), (scene.textures.child, arr["tex_child"]),
             (scene.media.center, arr["med_center"]), (scene.media.radius, arr["med_radius"]),
             (scene.media.density, arr["med_density"]), (scene.media.mat_id, arr["med_mat"])]
    for port, ref in pairs:
        np.testing.assert_array_equal(port.numpy(), ref)
    cam = conf["camera"]
    for key in ("vfov", "lookfrom", "lookat", "vup", "defocus_angle", "focus_dist", "background",
                "aspect_ratio"):
        assert np.allclose(getattr(cfg, key), cam[key]), key
    assert (cfg.image_width, cfg.max_depth) == (conf["image_width"], conf["max_depth"])


def test_perlin_tables_and_texels_equal_the_ports(recipe):
    conf, arr = recipe
    scene, _ = build(conf["port_scene"], device="cpu")
    np.testing.assert_array_equal(scene.perlin.randvec.numpy(), arr["perlin_vec"])
    perm = torch.stack([scene.perlin.perm_x, scene.perlin.perm_y, scene.perlin.perm_z])
    np.testing.assert_array_equal(perm.numpy(), arr["perlin_perm"])
    (img,) = arr["images"]
    h, w = scene.atlas.sizes[0].tolist()
    assert img.shape == (h, w, 3) == (512, 1024, 3)
    np.testing.assert_array_equal(scene.atlas.texels[0, :h, :w].numpy(), img)


@pytest.mark.parametrize("seed", [2**41 + 3, 2**40 + 9])
def test_render_equals_the_reference(recipe, seed):
    """Renderer's default path (K1's plain version on CPU tensors) against
    the plain reference, the camera in front of the blue medium."""
    conf, arr = recipe
    width, spp, depth = 32, 4, 12
    seed = compare.render_seed(seed)
    scene, cfg = build(conf["port_scene"], device="cpu", image_width=width,
                       samples_per_pixel=spp, max_depth=depth, **NEAR_BLUE)
    r = Renderer(cfg)
    assert r.resolve_hit_method(scene) == "mega"
    mb.medium_scatters.reset()
    res = r.render(scene, seed=seed)
    scatters = int(mb.medium_scatters)
    cam = tracer.Camera(dict(conf["camera"], **{k: list(v) for k, v in NEAR_BLUE.items()}),
                        width, "cpu")
    rad, segs, ref_scatters = final.render_pixels(final.FinalScene(arr, "cpu"), cam,
                                                  torch.arange(cfg.n_pixels), spp, depth, seed)
    assert res.segments == int(segs.sum())
    assert scatters == ref_scatters > res.segments // 2
    assert np.abs(res.radiance.reshape(-1, 3) - rad.numpy()).max() < 1e-5


def test_scene_compile_is_a_span_behind_the_switch():
    """``SceneBuilder.compile`` is the span ``rt.scene.compile`` with the
    port's tracing switch on, and no span with it off."""
    from raytracing_tpu_torch.utils import profiling as pf

    def names(on):
        with torch.profiler.profile() as prof:
            pf.enable(on)
            try:
                _medium_scene(0.5)
            finally:
                pf.enable(False)
        return {e.name for e in prof.events()}

    assert "rt.scene.compile" in names(True)
    assert "rt.scene.compile" not in names(False)


def _medium_scene(density, radius=2.0):
    """One medium of ``density`` in a sphere of ``radius`` at the origin,
    and a light quad beyond it."""
    b = SceneBuilder()
    b.quad((-50.0, -50.0, -20.0), (100.0, 0.0, 0.0), (0.0, 100.0, 0.0), b.diffuse_light((1, 1, 1)))
    b.constant_medium((0.0, 0.0, 0.0), radius, density, (0.5, 0.6, 0.7))
    return b.compile("cpu", use_bvh=False)


def _rays(o, d):
    n = len(o)
    o, d = torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32)
    pix = torch.arange(n, dtype=torch.int64)
    ray_f, ray_i = mb.pack_rays(o, d, torch.zeros(n), pix, torch.zeros(n, dtype=torch.int64))
    return ray_f, ray_i


# rays: from inside the boundary (the centre, off-centre), from outside
# towards it, and one that misses it
EDGE_O = [(0.0, 0.0, 0.0), (0.5, -0.3, 1.0), (0.0, 0.0, 10.0), (0.0, 5.0, 10.0)]
EDGE_D = [(0.0, 0.0, -1.0), (0.3, 0.2, -2.0), (0.0, 0.0, -1.0), (0.0, 0.0, -1.0)]


def _first_bounce(density):
    mega = build_mega_scene(_medium_scene(density))
    ray_f, ray_i = _rays(EDGE_O * 256, EDGE_D * 256)
    st = list(ray_f.unbind(0))
    t, ib = mb._closest_hit(mega, *st[mb.OX:mb.TM + 1])
    tm, ibm = mb._media_hit(mega, st, t, ib, 0, 0, 11, ray_i[0], ray_i[1])
    return mega, ray_f, ray_i, t, tm, ibm


def test_medium_edge_cases():
    # density 0: never scatters (-1/density is -inf, the free path +inf)
    _, _, _, t, tm, ib = _first_bounce(0.0)
    assert torch.equal(tm, t) and not bool((ib <= -2).any())
    # a huge density scatters at the entry: T_MIN from inside, the boundary from outside
    _, ray_f, _, t, tm, ib = _first_bounce(1e30)
    inside = torch.tensor([True, True, False, False] * 256)
    miss = torch.tensor([False, False, False, True] * 256)
    assert bool((ib[~miss] == -2).all()) and bool((ib[miss] == ib[miss][0]).all())
    assert torch.equal(tm[inside], torch.full_like(tm[inside], np.float32(1e-3)))
    assert torch.allclose(tm[2::4], torch.full_like(tm[2::4], 8.0))
    # a ray that misses the boundary keeps its surface hit, whatever the density
    for density in (1e-4, 1.0, 1e30):
        _, _, _, t, tm, ib = _first_bounce(density)
        assert torch.equal(tm[miss], t[miss]) and not bool((ib[miss] <= -2).any())
    # a moderate density: from inside, some rays scatter before the exit, at t > T_MIN
    _, _, _, t, tm, ib = _first_bounce(0.5)
    won = ib <= -2
    assert 0 < int(won[inside].sum()) < int(inside.sum())
    assert bool((tm[won & inside] > 1e-3).all()) and bool((tm[won] < t[won]).all())


HOST_HARNESS = r"""
#include "megakernel_block.cu"
template <bool M, bool N, bool I, bool W>
static int run(const TraceParams& p) {
  const float4* s = reinterpret_cast<const float4*>(p.sph);
  const float4* q = reinterpret_cast<const float4*>(p.quad);
  const float4* nd = reinterpret_cast<const float4*>(p.nodes);
  int scatters = 0;
  for (int i = 0; i < p.n; ++i)
    scatters += trace_ray<M, N, I, false, W, true>(p, s, q, nd, p.perm, p.grad, i);
  return scatters;
}
template <bool M, bool W>
static int run_tex(const TraceParams& p, int noise, int image) {
  if (noise) return image ? run<M, true, true, W>(p) : run<M, true, false, W>(p);
  return image ? run<M, false, true, W>(p) : run<M, false, false, W>(p);
}
extern "C" int host_trace_media(const float* sph, int n_sph_rows, const float* quad,
    int n_quad_rows, const float* table, int n_res_cols, const float* ray_f,
    const int* ray_i, int n, float* out_rad, int* out_bc, float* out_state,
    uint32_t seed, uint32_t b_off, int max_depth, int ns_pad, float bg_r, float bg_g,
    float bg_b, int moving, int noise, int image, const int* perm, const float* grad,
    const float* atlas, const float* nodes, int n_nodes, const int* sph_gid,
    int n_sph_chunks, const int* quad_gid, const float* ball, int walk, int n_media,
    const float* media) {
  TraceParams p{};
  p.sph = sph; p.n_sph_rows = n_sph_rows; p.quad = quad; p.n_quad_rows = n_quad_rows;
  p.table = table; p.n_res_cols = n_res_cols; p.ray_f = ray_f; p.ray_i = ray_i; p.n = n;
  p.out_rad = out_rad; p.out_bc = out_bc; p.out_state = out_state;
  p.seed = seed; p.b_off = b_off; p.max_depth = max_depth; p.ns_pad = ns_pad;
  p.bg_r = bg_r; p.bg_g = bg_g; p.bg_b = bg_b; p.perm = perm; p.grad = grad; p.atlas = atlas;
  p.nodes = nodes; p.n_nodes = n_nodes; p.sph_gid = sph_gid; p.n_sph_chunks = n_sph_chunks;
  p.quad_gid = quad_gid; p.ball_x = ball[0]; p.ball_y = ball[1]; p.ball_z = ball[2];
  p.ball_r2 = ball[3]; p.band_k = ball[4]; p.n_media = n_media; p.media = media;
  if (walk) return moving ? run_tex<true, true>(p, noise, image) : run_tex<false, true>(p, noise, image);
  return moving ? run_tex<true, false>(p, noise, image) : run_tex<false, false>(p, noise, image);
}
"""


@pytest.fixture(scope="module")
def host_media():
    """K1's per-ray math with MEDIUM (csrc/megakernel_block.cu without
    __CUDACC__) built for the host, without FMA contraction."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernel's per-ray math")
    import tempfile

    d = Path(tempfile.mkdtemp(prefix="k1media"))
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libk1media.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{CSRC}", str(d / "harness.cpp"), "-o", str(so)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.host_trace_media.argtypes = [P, I, P, I, P, I, P, P, I, P, P, P, U, U, I, I, F, F, F,
                                     I, I, I, P, P, P, P, I, P, I, P, P, I, I, P]
    lib.host_trace_media.restype = ctypes.c_int
    return lib


def _host_trace(lib, mega, ray_f, ray_i, seed, b_off, depth, background, walk):
    n = ray_i.shape[1]
    rad, bc = torch.empty(3, n), torch.empty(n, dtype=torch.int32)
    state = torch.empty(mb.N_F, n)
    ball = torch.tensor(mega.cull_ball, dtype=torch.float32)
    scatters = lib.host_trace_media(
        mega.sph_sweep.data_ptr(), mega.n_sph, mega.quad_sweep.data_ptr(), mega.n_quad,
        mega.table.data_ptr(), mega.n_prims, ray_f.data_ptr(), ray_i.data_ptr(), n,
        rad.data_ptr(), bc.data_ptr(), state.data_ptr(), seed, b_off, depth, mega.n_sph_pad,
        *background, int(mega.moving), int(mega.has_noise), int(mega.has_image),
        mega.perm.data_ptr(), mega.grad.data_ptr(), mega.atlas.data_ptr(),
        mega.cull_nodes.data_ptr(), mega.cull_nodes.shape[0], mega.sph_gid.data_ptr(),
        mega.n_sph_chunks, mega.quad_gid.data_ptr(), ball.data_ptr(), int(walk), mega.n_media,
        mega.media.data_ptr())
    return rad, bc, state, scatters


@pytest.mark.parametrize("case", ["edges", "near_blue"])
def test_kernel_source_media_on_the_host_match_plain(host_media, case):
    """The MEDIUM instantiation's per-ray math against the plain version:
    the edge rays at four densities (the sweep), and camera rays of the
    final scene in front of the blue medium, from phase offset 3 (the walk
    and the sweep, bit for bit each other). Host libm and PyTorch may
    differ by an ulp in sqrt, sin and cos, and a grazing hit turns that
    into another path: a ray agrees when its bounces are equal and its
    radiance within 1e-5; every ray of the edge cases agrees, and at most
    max(4, n/200) of the scene's camera rays do not (measured: 1 of
    2,048), the scatters differing by at most a path's length for each."""
    runs = []
    if case == "edges":
        ray_f, ray_i = _rays(EDGE_O * 64, EDGE_D * 64)
        for density in (0.0, 0.5, 3.0, 1e30):
            runs.append((build_mega_scene(_medium_scene(density)), ray_f, ray_i, 8, (0, 0, 0),
                         (False,)))
    else:
        scene, cfg = build("next_week_final", device="cpu", image_width=32, samples_per_pixel=2,
                           max_depth=12, **NEAR_BLUE)
        from raytracing_tpu_torch.render import camera as cam

        pix = torch.arange(2048) % cfg.n_pixels
        smp = torch.arange(2048) // cfg.n_pixels
        derived = cam.derive(cfg, cam.CameraParams.from_config(cfg, "cpu"))
        o, d, t = cam.generate_rays(cfg, derived, pix, smp, 7, motion_blur=True)
        ray_f, ray_i = mb.pack_rays(o, d, t, pix, smp)
        runs.append((build_mega_scene(scene), ray_f, ray_i, 12, cfg.background, (False, True)))
    total = 0
    for mega, ray_f, ray_i, depth, bg, searches in runs:
        mb.medium_scatters.reset()
        ref = mb.trace_block_torch(mega, ray_f, ray_i, 7, 3, max_depth=depth, background=bg)
        ref_scatters = int(mb.medium_scatters)
        outs = [_host_trace(host_media, mega, ray_f, ray_i, 7, 3, depth, bg, w) for w in searches]
        for out in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(out[:3], outs[0][:3]))
        rad, bc, state, scatters = outs[0]
        bad = int(((bc != ref[1]) | ((rad - ref[0]).abs() > 1e-5).any(0)).sum())
        assert bad <= (0 if case == "edges" else max(4, bc.numel() // 200))
        assert abs(scatters - ref_scatters) <= depth * bad
        total += scatters
    assert total > 0


def test_culled_search_equals_brute_force(recipe):
    """The reference's search by groups of spheres and quads finds every
    ray's winner and distance as brute force does: camera rays, rays from
    the surfaces of spheres and boxes, and rays from anywhere in the fog."""
    conf, arr = recipe
    culled, brute = final.FinalScene(arr, "cpu"), final.FinalScene(arr, "cpu", culled=False)
    assert culled.sph_groups is not None and culled.quad_groups is not None
    cam = tracer.Camera(conf["camera"], 200, "cpu")
    g = torch.Generator().manual_seed(5)
    n = 6_000
    o, d, tm = cam.rays(torch.randint(0, 200 * 200, (n,), generator=g),
                        torch.randint(0, 250, (n,), generator=g), 2**31 - 3, True)
    sid = torch.randint(0, culled.n_sph, (n,), generator=g)
    out = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    o2 = culled.center[sid] + out * culled.radius[sid, None]
    qid = torch.randint(0, culled.n_quad, (n,), generator=g)
    ab = torch.rand(n, 2, generator=g)
    o3 = culled.q_q[qid] + ab[:, :1] * culled.q_u[qid] + ab[:, 1:] * culled.q_v[qid]
    o4 = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1) * (
        5000.0 * torch.rand(n, 1, generator=g) ** (1 / 3))
    O = torch.cat([o, o2, o3, o4])
    D = torch.cat([d, torch.randn(3 * n, 3, generator=g)])
    T = torch.cat([tm, torch.rand(3 * n, generator=g)])
    a, b = final.closest(culled, O, D, T), final.closest(brute, O, D, T)
    assert int((a[0] >= 0).sum()) > n // 2 and int((a[1] >= 0).sum()) > n // 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_bfloat16_control_fails_the_limits(recipe):
    """The reference computed in bfloat16 in the program's place, at a small
    size: it fails one of the new cell's limits at least."""
    conf, arr = recipe
    limits = json.loads((ROOT / "benchmark" / "limits" / "next_week_final.final_800.json")
                        .read_text())
    seed = compare.render_seed(2**42 + 11)
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        cam = tracer.Camera(conf["camera"], 24, "cpu", dtype)
        runs[dtype] = final.render_pixels(final.FinalScene(arr, "cpu", dtype), cam,
                                          torch.arange(cam.width * cam.height), 4, 10, seed)
    ref, low = runs[torch.float32], runs[torch.bfloat16]
    nums = compare.render_numbers(low[0].numpy(), int(low[1].sum()), True, ref[0].numpy(),
                                  ref[1].numpy(), ref[0].shape[0])
    assert any(nums[k] > limits[k] for k in limits), nums


def _refusals():
    from raytracing_tpu_torch.diff import replay, replay_fast
    from raytracing_tpu_torch.ops import megakernel_group as mg
    from raytracing_tpu_torch.ops.megakernel import trace_megakernel
    from raytracing_tpu_torch.render import integrator

    scene, cfg = build("next_week_final", device="cpu", image_width=16, samples_per_pixel=1,
                       max_depth=4)
    mega = build_mega_scene(scene)
    ray_f, ray_i = _rays([(478.0, 278.0, -600.0)] * 1024, [(-0.3, 0.0, 1.0)] * 1024)
    o, d, t = ray_f[:3].T.contiguous(), ray_f[3:6].T.contiguous(), ray_f[6]
    pix, smp = ray_i[0].long(), ray_i[1].long()
    return {
        "k5": lambda: mg.trace_group(mega, ray_f, ray_i, 1, 0, max_depth=2, background=(0, 0, 0),
                                     use_bvh=True),
        "k5 layout": lambda: trace_megakernel(mega, o, d, t, pix, smp, (0, 0, 0), 2, 1,
                                              layout="group"),
        "integrator": lambda: integrator.trace(scene, o, d, t, pix, smp, (0, 0, 0), 2, 1),
        "renderer brute": lambda: Renderer(cfg, hit_method="brute").render(scene),
        "decision pass": lambda: replay.record_decisions(scene, o, d, t, pix, smp, (0, 0, 0),
                                                         2, 1),
        "replay": lambda: replay_fast.replay_trace_fast(
            scene, torch.full((2, 1024), -1, dtype=torch.int32), o, d, t, pix, smp, (0, 0, 0),
            2, 1),
        "k1 ids": lambda: mb.trace_block(mega, ray_f, ray_i, 1, 0, max_depth=2,
                                         background=(0, 0, 0), want_ids=True),
        "pool": lambda: Renderer(cfg, schedule="pool").render(scene),
    }


@pytest.mark.parametrize("path", ["k5", "k5 layout", "integrator", "renderer brute",
                                  "decision pass", "replay", "k1 ids", "pool"])
def test_paths_without_media_refuse_them(path):
    with pytest.raises(ValueError, match="media"):
        _refusals()[path]()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**33 + 1, 2**31 - 7])
def test_k1_medium_equals_its_plain_version_on_the_card(seed):
    """The MEDIUM instantiation (11101: moving, marble, image, the walk)
    against its plain version on the card, bit for bit, at the cell's
    launch shape (800x800: 262,144 rays): the first phase of 2 bounces
    from the camera, then 38 bounces from its state, with the medium
    scatters counted equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from raytracing_tpu_torch.render import camera as cam
    from raytracing_tpu_torch.render.renderer import chunk_ids

    dev = torch.device("cuda", 0)
    scene, cfg = build("next_week_final", device=dev, samples_per_pixel=250)
    r = Renderer(cfg)
    mega = build_mega_scene(scene)
    start = cam.CameraStart.of(cfg, cam.pack_camera(cam.derive(
        cfg, cam.CameraParams.from_config(cfg, dev))), True)
    pix, smp, _, alive = chunk_ids(cfg, 0, 0, n_block=r.n_block, spp_chunk=r.spp_chunk,
                                   device=dev)
    assert pix.numel() == 262_144
    ray_i = torch.stack([pix, smp]).to(torch.int32)
    seed = compare.render_seed(seed)
    kw = dict(background=cfg.background)
    outs = {}
    for name, fn in (("kernel", mb.trace_block), ("plain", mb.trace_block_torch)):
        mb.medium_scatters.reset()
        first = fn(mega, None, ray_i, seed, 0, max_depth=2, camera=start, alive=alive, **kw)
        rest = fn(mega, first[2], ray_i, seed, 2, max_depth=38, **kw)
        torch.cuda.synchronize()
        outs[name] = (*first, *rest, int(mb.medium_scatters))
    k, p = outs["kernel"], outs["plain"]
    assert k[-1] == p[-1] > 0
    for a, b in zip(k[:-1], p[:-1]):
        assert (a is None and b is None) or torch.equal(a, b)
