"""The port's regenerating pool (``render/pool.py``, ``Renderer(schedule=
"pool")``) against its own phased megakernel trace, as tests/test_pool.py
holds the JAX package's pool against its phased path, and once against
the JAX package's XLA renderer; each driver of the pool's loop (the host
loop, ``fused=False``, and the fused program, which on the CPU runs its
warm-up step and re-initializes, as on a card before the capture) is
held to the same bars.

Bars (tests/test_pool.py): each path is bit-identical (the same kernel
arithmetic, and the per-ray depth continues each ray's RNG stream), so a
1-spp image equals the phased one exactly and segments are exact
everywhere; with more samples the per-pixel sums add in another order,
held at 2e-6. Against the JAX package's XLA integrator, max |Δ| < 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.render.renderer import Renderer as JRenderer
from raytracing_tpu_torch import Renderer, build
from raytracing_tpu_torch.ops import megakernel_block as mb
from raytracing_tpu_torch.ops.megakernel import build_mega_scene, trace_megakernel
from raytracing_tpu_torch.render import camera as cam_mod
from raytracing_tpu_torch.render import pool as pool_mod
from raytracing_tpu_torch.render.camera import CameraParams

torch.set_num_threads(2)
SEED = 3


def _phased_reference(scene, cfg):
    """Per-pixel radiance sums and segments of the phased K1 trace."""
    mega = build_mega_scene(scene)
    n_pix, spp = cfg.n_pixels, cfg.samples_per_pixel
    npad = -(-n_pix // 1024) * 1024
    pix = torch.clamp(torch.arange(npad), max=n_pix - 1).repeat(spp)
    smp = torch.arange(spp).repeat_interleave(npad)
    act0 = (torch.arange(npad) < n_pix).repeat(spp)
    o, d, t = cam_mod.generate_rays(cfg, cam_mod.derive(cfg, CameraParams.from_config(
        cfg, "cpu")), pix, smp, SEED, motion_blur=scene.flags.has_moving)
    rad, seg = trace_megakernel(mega, o, d, t, pix, smp, cfg.background, cfg.max_depth, SEED,
                                phase_depths=[2, cfg.max_depth - 2], active0=act0,
                                layout="block")
    rad = rad * act0[:, None]
    return rad.reshape(spp, npad, 3)[:, :n_pix].sum(dim=0), int(seg)


FUSED = pytest.mark.parametrize("fused", [False, True], ids=["loop", "fused"])


def _pool(scene, cfg, **kw):
    kw.setdefault("pool_size", 2048)
    rad, seg = pool_mod.trace_pool(build_mega_scene(scene), cfg,
                                   CameraParams.from_config(cfg, "cpu"), SEED,
                                   motion_blur=scene.flags.has_moving, **kw)
    return rad, int(seg)


@FUSED
def test_bit_identical_at_1spp(fused):
    """One sample: the per-pixel sum is the path itself, so the pool
    equals the phased trace bit for bit."""
    before_mb = int(mb.launches)
    scene, cfg = build("three_spheres", device="cpu", image_width=32, samples_per_pixel=1,
                       max_depth=8)
    want, wseg = _phased_reference(scene, cfg)
    got, gseg = _pool(scene, cfg, fused=fused)
    assert int(mb.launches) == before_mb  # CPU tensors ran K1's plain version
    assert torch.equal(got, want) and gseg == wseg


@FUSED
def test_refilled_lanes_bit_identical(fused):
    """A pool smaller than the stream: lanes are refilled with the next
    gids for several iterations, and every path still equals the phased
    trace's bit for bit (1 spp, so the per-pixel sum is the path)."""
    scene, cfg = build("cornell_box", device="cpu", image_width=48, samples_per_pixel=1,
                       max_depth=7)
    assert cfg.n_pixels > 2 * 1024
    want, wseg = _phased_reference(scene, cfg)
    got, gseg = _pool(scene, cfg, pool_size=1024, fused=fused)
    assert torch.equal(got, want) and gseg == wseg


@FUSED
def test_multi_sample_close_and_segments_exact(fused):
    scene, cfg = build("three_spheres", device="cpu", image_width=24, samples_per_pixel=4,
                       max_depth=6)
    want, wseg = _phased_reference(scene, cfg)
    got, gseg = _pool(scene, cfg, fused=fused)
    assert gseg == wseg
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6, atol=2e-6)


def test_depth_cap_paths():
    """An enclosed scene at a low cap: many rays end at the per-ray depth
    cap inside K1, the pool's own code path."""
    scene, cfg = build("cornell_box", device="cpu", image_width=16, samples_per_pixel=2,
                       max_depth=5)
    want, wseg = _phased_reference(scene, cfg)
    got, gseg = _pool(scene, cfg, pool_size=1024)
    assert gseg == wseg
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6, atol=2e-6)


def test_moving_and_textured_scene():
    """bouncing_spheres: motion blur (each ray's time regenerated from its
    gid) and the checker, the bench scene's features."""
    scene, cfg = build("bouncing_spheres", device="cpu", image_width=16, samples_per_pixel=2,
                       max_depth=6)
    want, wseg = _phased_reference(scene, cfg)
    got, gseg = _pool(scene, cfg, pool_size=1024)
    assert gseg == wseg
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6, atol=2e-6)


def test_marble_scene():
    """perlin_sphere through the pool: K1's marble at per-ray depths."""
    scene, cfg = build("perlin_sphere", device="cpu", image_width=16, samples_per_pixel=1,
                       max_depth=4)
    want, wseg = _phased_reference(scene, cfg)
    got, gseg = _pool(scene, cfg, pool_size=1024)
    assert torch.equal(got, want) and gseg == wseg


@FUSED
def test_renderer_pool_schedule(monkeypatch, fused):
    """Renderer(schedule="pool") end to end, with a split into two sample
    windows forced by a small MAX_POOL_STREAM (fused: one program serves
    both), against the phased Renderer."""
    scene, cfg = build("three_spheres", device="cpu", image_width=16, samples_per_pixel=4,
                       max_depth=4)
    base = Renderer(cfg).render(scene, seed=SEED)
    monkeypatch.setattr(pool_mod, "MAX_POOL_STREAM", cfg.n_pixels * 2 + 1)
    res = Renderer(cfg, schedule="pool", fused=fused).render(scene, seed=SEED)
    assert res.launches == 2 and res.segments == base.segments
    np.testing.assert_allclose(res.radiance, base.radiance, rtol=3e-6, atol=3e-6)


@FUSED
def test_pool_u8_transfer_matches(fused):
    """transfer="u8" (one window, quantized on the device) gives the f32
    pool render's u8 image and segments."""
    scene, cfg = build("three_spheres", device="cpu", image_width=16, samples_per_pixel=2,
                       max_depth=4)
    rf = Renderer(cfg, schedule="pool", fused=fused).render(scene, seed=SEED)
    ru = Renderer(cfg, schedule="pool", transfer="u8", fused=fused).render(scene, seed=SEED)
    assert ru.radiance is None and ru.u8 is not None and ru.launches == 1
    assert ru.segments == rf.segments
    np.testing.assert_array_equal(ru.image_u8, rf.image_u8)


JAX_KW = dict(image_width=16, samples_per_pixel=4, max_depth=4)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's XLA renderer (``hit_method="brute"``) on
    three_spheres, rendered once for both drivers of the pool."""
    sj, cfg_j = jbuild("three_spheres", **JAX_KW)
    ref = JRenderer(cfg_j, hit_method="brute", mode="scan", fused=False).render(sj, seed=SEED)
    return np.asarray(ref.radiance), int(ref.segments)


@FUSED
def test_pool_matches_jax_xla_renderer(jax_reference, fused):
    """The port's pool against the JAX package's XLA renderer on the same
    scene and seed."""
    ref_rad, ref_seg = jax_reference
    scene, cfg = build("three_spheres", device="cpu", **JAX_KW)
    res = Renderer(cfg, schedule="pool", fused=fused).render(scene, seed=SEED)
    assert res.segments == ref_seg
    assert res.radiance.shape == ref_rad.shape
    assert float(np.abs(res.radiance - ref_rad).max()) < 1e-5


def test_pool_refuses_what_it_cannot_trace():
    scene, cfg = build("three_spheres", device="cpu", image_width=8, samples_per_pixel=1,
                       max_depth=4)
    mega = build_mega_scene(scene)
    params = CameraParams.from_config(cfg, "cpu")
    with pytest.raises(ValueError, match="multiple"):
        pool_mod.trace_pool(mega, cfg, params, SEED, pool_size=1000)
    with pytest.raises(ValueError, match="max_depth"):
        pool_mod.trace_pool(mega, dataclasses.replace(cfg, max_depth=64), params, SEED)
    with pytest.raises(ValueError, match="schedule"):
        Renderer(cfg, schedule="wavefront")
