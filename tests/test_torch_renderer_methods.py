"""The port's ``Renderer`` hit methods on the CPU: ``"brute"`` (the
wavefront integrator with the brute-force closest hit) against the JAX
package's ``Renderer(hit_method="brute")`` launch, compiled with
``jit_run``, on two scenes the megakernels' tables cannot express (a
bilinear-filtered image, a checker of checkers); ``"auto"`` choosing the
megakernel exactly on the scenes it can express; and the refusals
(``tests/test_torch_traverse.py`` holds ``"bvh"`` and its ``"auto"``
choice).

Bars (ROADMAP parity bar for the integrator): radiance mean |Δ| < 1e-3,
segments within max(4, s/200). XLA on the CPU contracts multiply-adds
into FMAs in jitted code and the port does not, so a grazing ray may take
another path.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.ops.intersect import closest_hit_brute as jbrute
from raytracing_tpu.render import camera as jcam
from raytracing_tpu.render.renderer import _render_chunk as jrender_chunk
from raytracing_tpu.scene.builder import SceneBuilder as JBuilder
from raytracing_tpu_torch import Renderer, build, render
from raytracing_tpu_torch.ops import megakernel_block as mb
from raytracing_tpu_torch.ops.megakernel import expressible
from raytracing_tpu_torch.render.camera import CameraConfig
from raytracing_tpu_torch.scene.builder import SceneBuilder as PBuilder
from torch_parity import jit_run, segments_close

torch.set_num_threads(2)
SEED = 5
CAMERA = dict(aspect_ratio=1.0, image_width=32, samples_per_pixel=2, max_depth=8, vfov=30.0,
              lookfrom=(0.0, 1.5, 6.0), lookat=(0.0, 0.3, 0.0), background=(0.7, 0.8, 1.0))


def _bilinear_image(b):
    """An image-textured sphere, filtered bilinearly, on a plain ground."""
    img = np.random.default_rng(5).random((6, 9, 3)).astype(np.float32)
    b.sphere((0.0, -100.0, 0.0), 99.5, b.lambertian((0.5, 0.5, 0.5)))
    b.sphere((0.0, 0.3, 0.0), 0.8, b.lambertian(b.image(img)))
    b.sphere((1.6, 0.0, 0.5), 0.5, b.metal((0.8, 0.7, 0.6), 0.1))
    return dict(image_bilinear=True)


def _nested_checker(b):
    """A checker whose even cells are another checker, on the ground and
    on a sphere."""
    inner = b.checker(0.5, (0.1, 0.2, 0.3), (0.9, 0.8, 0.7))
    outer = b.checker(2.0, inner, (0.4, 0.5, 0.6))
    b.sphere((0.0, -100.0, 0.0), 99.5, b.lambertian(outer))
    b.sphere((0.0, 0.3, 0.0), 0.8, b.lambertian(outer))
    b.sphere((-1.6, 0.0, 0.5), 0.5, b.dielectric(1.5))
    return {}


SCENES = {"bilinear_image": _bilinear_image, "nested_checker": _nested_checker}


def _port(name):
    b = PBuilder()
    return b.compile(device="cpu", **SCENES[name](b)), CameraConfig(**CAMERA)


@functools.lru_cache(maxsize=None)
def _jax_render(name):
    """The JAX Renderer's brute launch (its ``_render_chunk``) over the
    whole image: mean radiance (H, W, 3) and segments."""
    b = JBuilder()
    scene = b.compile(use_bvh=False, **SCENES[name](b))
    cfg = jcam.CameraConfig(**CAMERA)
    n_block = -(-cfg.n_pixels // 1024) * 1024
    fn = functools.partial(jrender_chunk, cfg=cfg, n_block=n_block,
                           spp_chunk=cfg.samples_per_pixel, hit_fn=jbrute, mode="scan",
                           remat=False)
    rad, seg = jit_run(fn, scene, jcam.CameraParams.from_config(cfg), jnp.int32(0),
                       jnp.int32(0), jnp.uint32(SEED))
    mean = np.asarray(rad)[:cfg.n_pixels] / cfg.samples_per_pixel
    return mean.reshape(cfg.image_height, cfg.image_width, 3), int(seg)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_brute_matches_jax_brute(name):
    """The port's brute render equals the JAX package's at the integrator
    bars; ``"auto"`` and the functional ``render()`` take the same path
    and give the same image."""
    before_mb = int(mb.launches)
    scene, cfg = _port(name)
    assert not expressible(scene)
    ref, ref_seg = _jax_render(name)
    out = Renderer(cfg, hit_method="brute").render(scene, seed=SEED)
    assert out.radiance.shape == ref.shape
    assert float(np.abs(out.radiance - ref).mean()) < 1e-3
    assert segments_close(ref_seg, out.segments), (ref_seg, out.segments)
    assert 0.05 < float(out.radiance.mean()) < 1.0
    auto = Renderer(cfg).render(scene, seed=SEED)
    np.testing.assert_array_equal(auto.radiance, out.radiance)
    assert auto.segments == out.segments
    fn = render(scene, cfg, seed=SEED)
    np.testing.assert_array_equal(fn.radiance, out.radiance)
    assert fn.segments == out.segments
    assert int(mb.launches) == before_mb


def test_auto_picks_the_megakernel_where_it_can():
    """``"auto"`` takes the megakernel on three_spheres, where its image
    is the ``"mega"`` one (with K1's search forced or not: on the CPU the
    plain version runs either way), and the integrator on the two scenes
    above."""
    scene, cfg = build("three_spheres", device="cpu", image_width=16, samples_per_pixel=2,
                       max_depth=4)
    assert Renderer(cfg).resolve_hit_method(scene) == "mega"
    auto = Renderer(cfg).render(scene, seed=SEED)
    mega = Renderer(cfg, hit_method="mega").render(scene, seed=SEED)
    np.testing.assert_array_equal(auto.radiance, mega.radiance)
    for cull in (True, False):
        forced = Renderer(cfg, cull=cull).render(scene, seed=SEED)
        np.testing.assert_array_equal(forced.radiance, mega.radiance)
    with pytest.raises(ValueError, match="cull must be"):
        Renderer(cfg, cull="walk").render(scene, seed=SEED)
    brute = Renderer(cfg, hit_method="brute").render(scene, seed=SEED)
    assert Renderer(cfg, hit_method="brute").resolve_hit_method(scene) == "brute"
    assert float(np.abs(brute.radiance - mega.radiance).max()) < 1e-5
    assert brute.segments == mega.segments
    for name in SCENES:
        s, c = _port(name)
        assert Renderer(c).resolve_hit_method(s) == "brute"
        assert Renderer(c, hit_method="mega").resolve_hit_method(s) == "mega"


def test_mega_and_bvh_refuse():
    """``"mega"`` raises on a scene it cannot express, advising
    ``"brute"``; ``"bvh"`` raises on a scene compiled without a BVH."""
    for name in SCENES:
        scene, cfg = _port(name)
        with pytest.raises(ValueError, match="hit_method='brute'"):
            Renderer(cfg, hit_method="mega").render(scene, seed=SEED)
        b = PBuilder()
        no_bvh = b.compile(device="cpu", use_bvh=False, **SCENES[name](b))
        with pytest.raises(ValueError, match="compiled without a BVH"):
            Renderer(cfg, hit_method="bvh").render(no_bvh, seed=SEED)
    cfg = CameraConfig(**CAMERA)
    with pytest.raises(ValueError, match="hit_method must be"):
        Renderer(cfg, hit_method="wavefront")


def test_brute_refuses_the_megakernel_schedules():
    """The pool schedule, phase prefixes and K1's search belong to the
    megakernel: a brute renderer refuses them when built, an ``"auto"``
    one when the scene takes the integrator."""
    scene, cfg = _port("bilinear_image")
    with pytest.raises(ValueError, match="hit_method='mega'"):
        Renderer(cfg, hit_method="brute", schedule="pool")
    with pytest.raises(ValueError, match="hit_method='mega'"):
        Renderer(cfg, hit_method="brute", phase_prefixes=(None, 1024, 1024))
    with pytest.raises(ValueError, match="hit_method='mega'"):
        Renderer(cfg, cull=True).render(scene, seed=SEED)
    with pytest.raises(ValueError, match="hit_method='mega'"):
        Renderer(cfg, schedule="pool").render(scene, seed=SEED)
    with pytest.raises(ValueError, match="hit_method='mega'"):
        Renderer(cfg).plan_phase_prefixes(scene, seed=SEED)
