"""The port's differentiable-rendering API against the JAX package's and
against itself: the replay tiers (``replay_trace``, ``replay_trace_fast``
with the K4 lookup's plain version), scene and camera gradients, a
finite-difference check and an albedo fit, at the JAX tests' sizes.

Bars. Inside the port the replay tiers equal the trace bit for bit (one
bounce body, the same float32 roots on every path). Against the JAX
package: scene gradients of ``replay_trace_fast`` on the *same* recorded
ids at rtol 2e-5 / atol 2e-6 (tests/test_replay_kernel.py's class: XLA's
FMA contraction and a reassociated reduction); the camera gradient on the
marble scene at rtol 1e-3 / atol 1e-4, inside the JAX package's own bar
for that scene (rtol 0.04 / atol 3e-3, tests/test_replay.py: the 7-octave
turbulence magnifies an ulp of t ~2^7 before the marble's sin).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.diff.gradients import mse_loss as jmse_loss
from raytracing_tpu.diff.replay import record_decisions as jrecord
from raytracing_tpu.diff.replay_fast import replay_trace_fast as jreplay_fast
from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.render.camera import CameraParams as JCameraParams
from raytracing_tpu_torch.diff import gradients as pgrad
from raytracing_tpu_torch.diff.optimize import fit_albedo
from raytracing_tpu_torch.diff.replay import (record_decisions, render_replay,
                                              render_replay_fast, replay_trace)
from raytracing_tpu_torch.diff.replay_fast import replay_trace_fast, supported_fast
from raytracing_tpu_torch.models.scenes import build as pbuild
from raytracing_tpu_torch.ops import table_gather as tg
from raytracing_tpu_torch.render import camera as pcam
from raytracing_tpu_torch.render.camera import CameraConfig
from raytracing_tpu_torch.render.integrator import trace
from raytracing_tpu_torch.scene.builder import SceneBuilder
from test_torch_integrator import camera_rays
from torch_parity import jit_run, port_params, port_scene, t

torch.set_num_threads(2)


def _with(scene, center=None, rgb=None):
    """``scene`` with its sphere centers and/or texture rgbs replaced."""
    if center is not None:
        scene = dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres,
                                                                       center=center))
    if rgb is not None:
        scene = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures,
                                                                        rgb=rgb))
    return scene


def _port_rays(scene, cfg, seed):
    n, spp = cfg.n_pixels, cfg.samples_per_pixel
    pix = torch.arange(n, dtype=torch.int32).repeat(spp)
    smp = torch.arange(spp, dtype=torch.int32).repeat_interleave(n)
    o, d, tm = pcam.generate_rays(cfg, pcam.derive(cfg, pcam.CameraParams.from_config(
        cfg, "cpu")), pix, smp, seed, motion_blur=scene.flags.has_moving)
    return o, d, tm, pix, smp


def _grads(loss, inputs):
    """``torch.autograd.grad`` with zeros for inputs the loss does not
    reach (flat shading: radiance does not depend on geometry at all)."""
    gs = torch.autograd.grad(loss, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, gs)]


def _finite(*ts):
    return all(bool(torch.isfinite(x).all()) for x in ts)


# ------------------------------------------------ the tiers inside the port

@pytest.mark.parametrize("name", ["three_spheres", "bouncing_spheres", "cornell_box", "quads",
                                  "checkered_spheres", "perlin_sphere", "simple_light"])
def test_replay_tiers_equal_trace(name):
    """``trace`` == ``replay_trace`` on its recorded ids, and where the
    packed table covers the scene ``replay_trace_fast`` == ``replay_trace``:
    radiance bit for bit, segments equal; the fast tier's scene gradients
    equal the full replay's to float32 reassociation."""
    scene, cfg = pbuild(name, device="cpu", image_width=24, samples_per_pixel=2, max_depth=6)
    rays = _port_rays(scene, cfg, 5)
    args = (cfg.background, cfg.max_depth, 5)
    rad, seg = trace(scene, *rays, *args)
    seg = int(seg)
    ids = record_decisions(scene, *rays, *args)
    rad_r, seg_r = replay_trace(scene, ids, *rays, *args)
    assert torch.equal(rad, rad_r) and seg == seg_r
    if not supported_fast(scene):
        assert scene.flags.has_noise
        return
    center = scene.spheres.center.clone().requires_grad_(True)
    rgb = scene.textures.rgb.clone().requires_grad_(True)
    target = torch.from_numpy(np.random.default_rng(0).random(rad.shape).astype(np.float32))
    grads = []
    for fn in (replay_trace, replay_trace_fast):
        r, s = fn(_with(scene, center, rgb), ids, *rays, *args)
        assert s == seg
        if fn is replay_trace_fast:
            assert torch.equal(r.detach(), rad)
        grads.append(_grads(((r - target) ** 2).mean(), (center, rgb)))
    for a, b in zip(*grads):
        assert _finite(a, b)
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------- against the JAX package

def test_replay_fast_scene_grads_match_jax():
    """∂MSE/∂(sphere centers, texture rgb) through ``replay_trace_fast`` on
    the JAX package's recorded ids, in both packages."""
    sj, cfg = jbuild("bouncing_spheres", image_width=24, samples_per_pixel=2, max_depth=8)
    rays = camera_rays(sj, cfg, seed=5)
    bg = jnp.asarray(cfg.background, jnp.float32)
    ids = jit_run(lambda *a: jrecord(sj, *a, bg, 8, jnp.uint32(5)), *rays)
    target = np.random.default_rng(1).random((rays[0].shape[0], 3)).astype(np.float32)

    def jloss(center, rgb):
        s = sj.replace(spheres=sj.spheres.replace(center=center),
                       textures=sj.textures.replace(rgb=rgb))
        rad, _ = jreplay_fast(s, ids, *rays, bg, 8, jnp.uint32(5))
        return jnp.mean((rad - target) ** 2)

    gj = jit_run(jax.grad(jloss, argnums=(0, 1)), sj.spheres.center, sj.textures.rgb)
    sp = port_scene(sj)
    center = sp.spheres.center.clone().requires_grad_(True)
    rgb = sp.textures.rgb.clone().requires_grad_(True)
    rad, _ = replay_trace_fast(_with(sp, center, rgb), t(ids), *(t(x) for x in rays),
                               cfg.background, 8, 5)
    gp = _grads(((rad - t(target)) ** 2).mean(), (center, rgb))
    assert float(gp[1].abs().sum()) > 0
    for a, b in zip(gp, gj):
        assert _finite(a)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-6)


def test_camera_grad_matches_jax():
    """``camera_grad`` through ``render_once`` on the marble scene against
    the JAX package's derivative of the same ``mse_loss`` with respect to
    ``lookfrom`` (forward mode, compiled with FAST_COMPILE: ~2x cheaper
    to build than the reverse mode, and XLA then contracts no FMA here;
    jitted at full optimisation its FMAs move this gradient by up to 4.4%),
    and the port's replay gives the same gradient."""
    sj, cfg_j = jbuild("perlin_sphere", image_width=10, samples_per_pixel=2, max_depth=3)
    target = np.zeros((cfg_j.image_height, cfg_j.image_width, 3), np.float32)
    pj = JCameraParams.from_config(cfg_j)
    gj = jit_run(jax.jacfwd(lambda lf: jmse_loss(sj, jnp.asarray(target), cfg_j,
                                                 params=pj.replace(lookfrom=lf), seed=4,
                                                 remat=False)), pj.lookfrom)
    sp, cfg = port_scene(sj), CameraConfig(**vars(cfg_j))
    gp = pgrad.camera_grad(sp, t(target), cfg, port_params(pj), seed=4)
    assert isinstance(gp, pcam.CameraParams)
    assert _finite(*(getattr(gp, f.name) for f in dataclasses.fields(gp)))
    assert float(gp.lookfrom.abs().sum()) > 0
    # well inside the JAX package's own bar for this scene (rtol 0.04, atol 3e-3)
    np.testing.assert_allclose(gp.lookfrom.numpy(), np.asarray(gj), rtol=1e-3, atol=1e-4)
    # through the replay: the same forward, so the same gradient
    lookfrom = port_params(pj).lookfrom.requires_grad_(True)
    params = dataclasses.replace(port_params(pj), lookfrom=lookfrom)
    img = render_replay(sp, cfg, params, seed=4)
    (g_rep,) = torch.autograd.grad(((img - t(target)) ** 2).mean(), lookfrom)
    torch.testing.assert_close(g_rep, gp.lookfrom, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------- the port on its own

def _marble_sphere_scene():
    """A marble sphere in the sky: every scattered ray escapes, so the
    radiance is smooth in geometry away from the silhouette
    (tests/test_grad.py)."""
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -3.0), 1.0, b.lambertian(b.noise(2.0)))
    cfg = CameraConfig(aspect_ratio=1.0, image_width=8, samples_per_pixel=2, max_depth=3,
                       background=(0.7, 0.8, 1.0), vfov=30.0, lookfrom=(0, 0, 0),
                       lookat=(0, 0, -1), focus_dist=1.0)
    return b.compile(device="cpu"), cfg


def test_sphere_center_grad_matches_finite_differences():
    """Autograd against central differences (eps 2e-3) on the components
    where the loss is locally smooth, as tests/test_grad.py ``_fd_check``."""
    scene, cfg = _marble_sphere_scene()

    def loss(center):
        img = pgrad.render_once(_with(scene, center=center), cfg, seed=1)
        return img[2:6, 2:6].mean()

    c0 = scene.spheres.center.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(c0), c0)
    assert _finite(g)
    f0 = float(loss(scene.spheres.center))
    eps, checked = 2e-3, 0
    for k in range(3):
        dp = torch.zeros_like(c0)
        dp[0, k] = eps
        with torch.no_grad():
            fp, fm = float(loss(scene.spheres.center + dp)), float(loss(scene.spheres.center - dp))
        fd = (fp - fm) / (2 * eps)
        if abs(fd) < 1e-4 or abs(fp + fm - 2 * f0) > 0.3 * abs(fp - fm):
            continue
        checked += 1
        np.testing.assert_allclose(float(g[0, k]), fd, rtol=0.08, atol=1e-4)
    assert checked > 0


def test_scene_grad_is_scene_shaped():
    """``scene_grad`` returns a Scene of gradients: finite, zero for the
    flat-shaded geometry, the rgb gradient equal to the replay's."""
    scene, cfg = pbuild("three_spheres", device="cpu", image_width=12, samples_per_pixel=1,
                        max_depth=3)
    target = torch.zeros((cfg.image_height, cfg.image_width, 3))
    g = pgrad.scene_grad(scene, target, cfg, seed=2)
    assert type(g) is type(scene) and g.spheres.center.shape == scene.spheres.center.shape
    assert _finite(g.spheres.center, g.textures.rgb, g.materials.fuzz)
    assert float(g.spheres.center.abs().max()) == 0.0 and float(g.textures.rgb.abs().sum()) > 0
    assert torch.equal(g.spheres.mat_id, scene.spheres.mat_id)
    rgb = scene.textures.rgb.clone().requires_grad_(True)
    img = render_replay(_with(scene, rgb=rgb), cfg, seed=2)
    (g_rgb,) = torch.autograd.grad(((img - target) ** 2).mean(), rgb)
    torch.testing.assert_close(g.textures.rgb, g_rgb, rtol=1e-5, atol=1e-8)


def test_render_replay_fast_on_cpu():
    """Decisions from the plain K1 (CPU tensors): the image matches the
    integrator-decided replay within the kernel-vs-XLA coin-flip bar of
    tests/test_replay.py, and ids passed back give finite gradients."""
    before_tg = int(tg.launches)
    scene, cfg = pbuild("bouncing_spheres", device="cpu", image_width=16, samples_per_pixel=2,
                        max_depth=5)
    img_ref = render_replay(scene, cfg, seed=3)
    img, seg, ids = render_replay_fast(scene, cfg, seed=3, return_segments=True,
                                       return_ids=True)
    assert float((img - img_ref).abs().mean()) < 3e-3 and seg > 0
    assert ids.shape == (5, 2048) and int(tg.launches) == before_tg
    center = scene.spheres.center.clone().requires_grad_(True)
    rgb = scene.textures.rgb.clone().requires_grad_(True)
    out = render_replay_fast(_with(scene, center, rgb), cfg, seed=3, ids=ids)
    g_center, g_rgb = _grads(out.mean(), (center, rgb))
    assert _finite(g_center, g_rgb) and float(g_rgb.abs().sum()) > 0


def test_render_replay_fast_raises_on_noise_textures():
    """render_replay_fast on the marble scene: K1's plain version shades
    marble, so its decisions drive the replay, and the image and the
    camera gradient match render_replay's (the integrator's decisions)
    within the JAX package's bars for this scene (tests/test_replay.py:
    the two closest-hit computations may send a grazing ray another way).
    A scene the tables cannot express (bilinear images) takes the
    integrator's decision pass and cannot return ids."""
    before_tg = int(tg.launches)
    scene, cfg = pbuild("perlin_sphere", device="cpu", image_width=10, samples_per_pixel=2,
                        max_depth=3)
    params = pcam.CameraParams.from_config(cfg, "cpu")
    target = torch.zeros((cfg.image_height, cfg.image_width, 3))

    def render_and_grad(fn):
        lookfrom = params.lookfrom.clone().requires_grad_(True)
        img = fn(scene, cfg, dataclasses.replace(params, lookfrom=lookfrom), seed=4)
        (g,) = torch.autograd.grad(((img - target) ** 2).mean(), lookfrom)
        return img.detach(), g

    img_fast, g_fast = render_and_grad(render_replay_fast)
    img_ref, g_ref = render_and_grad(render_replay)
    assert int(tg.launches) == before_tg
    assert float((img_fast - img_ref).abs().mean()) < 1e-3
    assert float(g_ref.abs().sum()) > 0
    assert torch.allclose(g_fast, g_ref, rtol=0.04, atol=3e-3), (g_fast, g_ref)
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian(b.image(np.full((4, 4, 3), 0.5, np.float32))))
    bilinear = b.compile(device="cpu", image_bilinear=True)
    with pytest.raises(ValueError, match="no ids"):
        render_replay_fast(bilinear, cfg, seed=4, return_ids=True)


def test_fit_albedo_recovers_albedo():
    scene, cfg = pbuild("single_sphere", device="cpu", image_width=16, samples_per_pixel=2,
                        max_depth=3)
    target = pgrad.render_once(scene, cfg, seed=0).detach()
    bad = _with(scene, rgb=scene.textures.rgb * 0.3)
    fitted, losses = fit_albedo(bad, target, cfg, steps=60, lr=5e-2, seed=0,
                                reseed_every_step=False)
    assert losses.shape == (60,) and bool(torch.isfinite(losses).all())
    assert losses[-1] < losses[0] * 0.1
    assert fitted.textures.rgb.shape == scene.textures.rgb.shape
