"""The integrator's BVH in the port against the JAX package: the host build
(``ops/bvh.py``, its vendored native builder), ``compile(use_bvh=True)``,
the lockstep walk (``ops/traverse.closest_hit_bvh``) against the JAX walk
and against the port's brute-force closest hit, its gradients, the
``translate`` case, and ``Renderer(hit_method="bvh")`` / ``"auto"``.

Bars: ``tests/test_bvh.py``'s (validity equal, ``t`` rtol 1e-5, the same
primitive on > 99.9% of rays) against the JAX walk, whose jitted arithmetic
carries XLA's FMAs; against the port's brute force the walk's winner and
``t`` are bit-equal except at exact ties. Renders: the integrator bars
(radiance mean |Δ| < 2e-3 on bouncing_spheres, segments within
max(4, s/200)).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.ops import bvh as jbvh
from raytracing_tpu.ops.traverse import closest_hit_bvh as jclosest_hit_bvh
from raytracing_tpu.render import camera as jcam
from raytracing_tpu.render.renderer import _render_chunk as jrender_chunk
from raytracing_tpu.scene.builder import SceneBuilder as JBuilder
from raytracing_tpu_torch import Renderer, build
from raytracing_tpu_torch.diff.gradients import scene_grad
from raytracing_tpu_torch.native import rt_native
from raytracing_tpu_torch.ops import bvh as pbvh
from raytracing_tpu_torch.ops import megakernel_block as mb
from raytracing_tpu_torch.ops import traverse
from raytracing_tpu_torch.ops.intersect import closest_hit_brute
from raytracing_tpu_torch.render.camera import CameraConfig
from raytracing_tpu_torch.scene.assets import read_ppm
from raytracing_tpu_torch.scene.builder import SceneBuilder as PBuilder
from torch_parity import (AXIS_RAYS, bilinear_grid, box_scene, jit_run, port_scene, noise_row,
                          noise_row_config, random_rays, random_scene, segments_close, t)

torch.set_num_threads(2)
BVH_FIELDS = ("bbox_min", "bbox_max", "prim", "miss")


def _single(b):
    b.sphere((0, 0, -3), 1.0, b.lambertian((1, 1, 1)))
    return b


BUILDS = {
    "random": lambda b: random_scene(b, 0),
    "moving": lambda b: random_scene(b, 7, moving=True),
    "quads_only": lambda b: random_scene(b, 4, n_spheres=0, n_quads=17),
    "single": _single,
}


def _bvh_arrays(scene):
    return {f: np.asarray(getattr(scene.bvh, f)) for f in BVH_FIELDS}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_bvh_equals_jax(name):
    """The compiled BVH equals the JAX package's, array for array, and has
    tests/test_bvh.py's structure: one leaf per primitive, 2n - 1 nodes, a
    root that skips to the end, unique leaf ids and child boxes inside
    their parents'."""
    bj, bp = BUILDS[name](JBuilder()), BUILDS[name](PBuilder())
    sj, sp = bj.compile(use_bvh=True), bp.compile(device="cpu")
    ref, out = _bvh_arrays(sj), _bvh_arrays(sp)
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(out[f], ref[f], err_msg=f)
    n_real = bp.n_spheres + bp.n_quads
    prim, miss = out["prim"], out["miss"]
    assert (prim >= 0).sum() == n_real and len(prim) == 2 * n_real - 1 and miss[0] == -1
    assert len(np.unique(prim[prim >= 0])) == n_real
    for i in range(len(prim) - 1):
        if prim[i] < 0:
            assert np.all(out["bbox_min"][i] <= out["bbox_min"][i + 1])
            assert np.all(out["bbox_max"][i] >= out["bbox_max"][i + 1])
    # the host build alone, from the same arrays, in both packages
    args = (np.asarray(bp.sph_center, np.float32).reshape(-1, 3),
            np.asarray(bp.sph_velocity, np.float32).reshape(-1, 3),
            np.asarray(bp.sph_radius, np.float32), np.asarray(bp.quad_q, np.float32).reshape(-1, 3),
            np.asarray(bp.quad_u, np.float32).reshape(-1, 3),
            np.asarray(bp.quad_v, np.float32).reshape(-1, 3), 8)
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(pbvh.build_bvh(*args), f),
                                      getattr(jbvh.build_bvh(*args), f), err_msg=f)
    np.testing.assert_array_equal(np.stack(pbvh.primitive_bounds(*args[:6])),
                                  np.stack(jbvh.primitive_bounds(*args[:6])))


def test_native_matches_numpy(tmp_path, monkeypatch):
    """The vendored native builder (built into ``_build/``) equals the NumPy
    build; ``RT_NATIVE=0`` turns it off per call; its PPM writer is
    byte-equal to the NumPy writer; a flat quad's box is padded."""
    assert rt_native.available()
    assert rt_native.library_path().parent.name == "_build"
    rng = np.random.default_rng(3)
    n = 127
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    r = rng.uniform(0.1, 2, n).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    nat = rt_native.build_bvh_flat(c - r[:, None], c + r[:, None], ids)
    empty = np.zeros((0, 3), np.float32)
    monkeypatch.setenv("RT_NATIVE", "0")
    assert not rt_native.available()
    fb = pbvh.build_bvh(c, np.zeros_like(c), r, empty, empty, empty, n)
    for got, f in zip(nat, BVH_FIELDS):
        np.testing.assert_array_equal(got, getattr(fb, f), err_msg=f)
    from raytracing_tpu_torch.utils.image_io import write_ppm

    rad = rng.random((5, 4, 3)).astype(np.float32)
    write_ppm(str(tmp_path / "numpy.ppm"), rad)
    monkeypatch.setenv("RT_NATIVE", "1")
    write_ppm(str(tmp_path / "native.ppm"), rad)
    assert (tmp_path / "native.ppm").read_bytes() == (tmp_path / "numpy.ppm").read_bytes()
    img = rng.integers(0, 256, (5, 4, 3), dtype=np.uint8)
    assert rt_native.write_ppm(str(tmp_path / "n.ppm"), img)
    np.testing.assert_array_equal(read_ppm(str(tmp_path / "n.ppm")), img)
    q, u, v = (np.array([x], np.float32) for x in ([0, 0, 0], [1, 0, 0], [0, 1, 0]))
    bmin, bmax = pbvh.primitive_bounds(empty, empty, np.zeros(0, np.float32), q, u, v)
    assert (bmax[0, 2] - bmin[0, 2]) >= 1e-4


@pytest.mark.parametrize("name", ["bouncing_spheres", "cornell_box"])
def test_registry_bvh_equals_jax(name):
    """``compile(use_bvh=True)`` on a registry scene: the same BVH as the
    JAX package's, on the port scene's device; the registry's defaults are
    the JAX package's (a BVH for bouncing_spheres only), and the
    conversion from the JAX scene carries it."""
    sj, _ = jbuild(name, use_bvh=True)
    sp, _ = build(name, device="cpu", use_bvh=True)
    ref = _bvh_arrays(sj)
    for scene in (sp, port_scene(sj)):
        assert scene.bvh.prim.device.type == "cpu" and scene.bvh.prim.dtype == torch.int32
        for f, value in _bvh_arrays(scene).items():
            np.testing.assert_array_equal(value, ref[f], err_msg=f)
    assert (build(name, device="cpu")[0].bvh is None) == (jbuild(name)[0].bvh is None)
    assert (build(name, device="cpu")[0].bvh is None) == (name != "bouncing_spheres")


WALK_CASES = {
    "seed0": (lambda b: random_scene(b, 0), lambda: random_rays(100)),
    "seed1": (lambda b: random_scene(b, 1), lambda: random_rays(101)),
    "seed2": (lambda b: random_scene(b, 2), lambda: random_rays(102)),
    "moving": (lambda b: random_scene(b, 7, moving=True), lambda: random_rays(200)),
    "axis_parallel": (lambda b: random_scene(b, 3), lambda: AXIS_RAYS),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_closest_hit_bvh(case):
    """The port's walk against the JAX walk (tests/test_bvh.py's bars) and
    against the port's brute force (winner and ``t`` bit-equal where no
    exact tie splits them)."""
    make, rays = WALK_CASES[case]
    sj = make(JBuilder()).compile(use_bvh=True)
    sp = make(PBuilder()).compile(device="cpu")
    o, d, tm = rays()
    hj = jit_run(jclosest_hit_bvh, sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    traverse.reset_stats()
    hv = traverse.closest_hit_bvh(sp, t(o), t(d), t(tm))
    assert traverse.stats["calls"] == 1 and traverse.stats["iterations"] > 0
    hb = closest_hit_brute(sp, t(o), t(d), t(tm))
    np.testing.assert_array_equal(hv.valid.numpy(), np.asarray(hj.valid))
    finite = np.isfinite(np.asarray(hj.t))
    np.testing.assert_allclose(hv.t.numpy()[finite], np.asarray(hj.t)[finite], rtol=1e-5)
    assert (hv.prim_id.numpy() == np.asarray(hj.prim_id)).mean() > 0.999
    assert bool(torch.equal(hv.valid, hb.valid))
    same = hv.prim_id == hb.prim_id
    assert same.float().mean() > 0.999
    assert bool(torch.equal(hv.t[same], hb.t[same]))
    assert bool(torch.equal(hv.p[same], hb.p[same]))
    if case == "seed0":
        assert int(hv.valid.sum()) > 50  # the rays do hit things


def test_single_primitive_and_no_bvh():
    """One sphere: the walk's t is 2; a scene without a BVH is refused."""
    sp = _single(PBuilder()).compile(device="cpu")
    h = traverse.closest_hit_bvh(sp, torch.zeros(1, 3), torch.tensor([[0.0, 0.0, -1.0]]),
                                 torch.zeros(1))
    assert float(h.t[0]) == pytest.approx(2.0, rel=1e-6) and int(h.prim_id[0]) == 0
    with pytest.raises(ValueError, match="without a BVH"):
        traverse.closest_hit_bvh(_single(PBuilder()).compile(device="cpu", use_bvh=False),
                                 torch.zeros(1, 3), torch.tensor([[0.0, 0.0, -1.0]]),
                                 torch.zeros(1))


def test_render_once_grads_bvh_equal_brute():
    """Gradients of ``render_once`` through the BVH hit equal those through
    the brute-force hit (the same winners; the sums over rays run in
    another order), on a scene with marble noise, whose geometry
    gradients are non-zero."""
    scene = noise_row(PBuilder()).compile(device="cpu")
    cfg = noise_row_config(CameraConfig)
    target = torch.full((cfg.image_height, cfg.image_width, 3), 0.3)
    g_bvh = scene_grad(scene, target, cfg, seed=4, hit_fn=traverse.closest_hit_bvh)
    g_brute = scene_grad(scene, target, cfg, seed=4, hit_fn=closest_hit_brute)
    for group, field in (("spheres", "center"), ("spheres", "radius"), ("textures", "rgb"),
                         ("quads", "q"), ("materials", "fuzz")):
        a = getattr(getattr(g_bvh, group), field)
        r = getattr(getattr(g_brute, group), field)
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5, atol=1e-9,
                                   err_msg=f"{group}.{field}")
    assert float(g_brute.spheres.center.abs().sum()) > 0


def test_translate_tables_and_bvh():
    """tests/test_translate.py's case: a box built inside ``translate``
    compiles to the tables and BVH of the same box baked at the offset, bit
    for bit, and to the JAX package's BVH."""
    baked = box_scene(PBuilder(), False).compile(device="cpu")
    moved = box_scene(PBuilder(), True).compile(device="cpu")
    for a, m in ((baked.quads.q, moved.quads.q), (baked.quads.u, moved.quads.u),
                 (baked.spheres.center, moved.spheres.center)):
        assert bool(torch.equal(a, m))
    ref = _bvh_arrays(box_scene(JBuilder(), True).compile())
    for f in BVH_FIELDS:
        assert bool(torch.equal(getattr(baked.bvh, f), getattr(moved.bvh, f))), f
        np.testing.assert_array_equal(getattr(moved.bvh, f).numpy(), ref[f], err_msg=f)


CAMERA = dict(image_width=32, samples_per_pixel=2, max_depth=4)


@functools.lru_cache(maxsize=None)
def _jax_bvh_render():
    """The JAX Renderer's launch with its BVH hit (``_render_chunk`` with
    ``closest_hit_bvh``) over the bouncing_spheres image."""
    scene, cfg = jbuild("bouncing_spheres", **CAMERA)
    n_block = -(-cfg.n_pixels // 1024) * 1024
    fn = functools.partial(jrender_chunk, cfg=cfg, n_block=n_block,
                           spp_chunk=cfg.samples_per_pixel, hit_fn=jclosest_hit_bvh,
                           mode="scan", remat=False)
    rad, seg = jit_run(fn, scene, jcam.CameraParams.from_config(cfg), jnp.int32(0),
                       jnp.int32(0), jnp.uint32(5))
    mean = np.asarray(rad)[:cfg.n_pixels] / cfg.samples_per_pixel
    return mean.reshape(cfg.image_height, cfg.image_width, 3), int(seg)


def test_renderer_bvh_matches_jax():
    """``Renderer(hit_method="bvh")`` against the JAX ``Renderer``'s BVH
    launch at the integrator bars, equal to the port's brute render (the
    same winners) and launching no kernel."""
    scene, cfg = build("bouncing_spheres", device="cpu", **CAMERA)
    ref, ref_seg = _jax_bvh_render()
    before = int(mb.launches)
    out = Renderer(cfg, hit_method="bvh").render(scene, seed=5)
    assert Renderer(cfg, hit_method="bvh").resolve_hit_method(scene) == "bvh"
    assert float(np.abs(out.radiance - ref).mean()) < 2e-3
    assert segments_close(ref_seg, out.segments), (ref_seg, out.segments)
    brute = Renderer(cfg, hit_method="brute").render(scene, seed=5)
    np.testing.assert_array_equal(out.radiance, brute.radiance)
    assert out.segments == brute.segments and int(mb.launches) == before
    with pytest.raises(ValueError, match="without a BVH"):
        Renderer(cfg, hit_method="bvh").render(
            build("bouncing_spheres", device="cpu", use_bvh=False, **CAMERA)[0], seed=5)


def test_auto_resolves_bvh():
    """``"auto"`` takes the BVH on an inexpressible scene with a BVH and
    more than 64 primitives (the JAX ``Renderer`` off the CPU), and the
    brute force without a BVH; the image is the ``"bvh"`` one."""
    cfg = CameraConfig(aspect_ratio=1.0, image_width=16, samples_per_pixel=2, max_depth=3,
                       vfov=30.0, lookfrom=(0.0, 1.5, 6.0), lookat=(0.0, 0.3, 0.0),
                       background=(0.7, 0.8, 1.0))
    scene = bilinear_grid(PBuilder()).compile(device="cpu", image_bilinear=True)
    assert scene.n_primitives > 64
    assert Renderer(cfg).resolve_hit_method(scene) == "bvh"
    no_bvh = bilinear_grid(PBuilder()).compile(device="cpu", image_bilinear=True,
                                                use_bvh=False)
    assert Renderer(cfg).resolve_hit_method(no_bvh) == "brute"
    traverse.reset_stats()
    auto = Renderer(cfg).render(scene, seed=2)
    assert traverse.stats["calls"] == cfg.max_depth
    bvh = Renderer(cfg, hit_method="bvh").render(scene, seed=2)
    np.testing.assert_array_equal(auto.radiance, bvh.radiance)
    assert auto.segments == bvh.segments and 0.05 < float(auto.radiance.mean()) < 1.0
    with pytest.raises(ValueError, match="hit_method='bvh'"):
        Renderer(cfg, schedule="pool").render(scene, seed=2)
    with pytest.raises(ValueError, match="hit_method='bvh'"):
        Renderer(cfg, hit_method="bvh", cull=True)
