"""K1 and K5 on the textured scenes, their plain versions on the CPU:
marble noise (perlin_sphere, simple_light) and the image (earth) against
the JAX package's XLA integrator (``integrator.trace`` with
``closest_hit_brute``, compiled by ``torch_parity.jit_run``), K5 against
K1 on the same rays, and every registry scene through ``Renderer``.

Bars (tests/test_megakernel.py, the JAX package's own for its kernel
against the same integrator): mean |Δ| < 1e-3 on the marble scenes (the
noise's floor at octave-7 frequencies turns an ulp of the hit point into
another lattice cell), max |Δ| < 1e-5 on earth, segments within
max(4, s/200).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.ops.intersect import closest_hit_brute
from raytracing_tpu.render.integrator import trace as jtrace
from raytracing_tpu_torch import SCENES, Renderer, build
from raytracing_tpu_torch.ops import megakernel_block as mb
from raytracing_tpu_torch.ops import megakernel_group as mg
from raytracing_tpu_torch.ops.intersect import hit_attributes
from raytracing_tpu_torch.ops.megakernel import build_mega_scene, trace_megakernel
from raytracing_tpu_torch.render import camera as pcam
from torch_parity import jit_run, port_scene, segments_close

torch.set_num_threads(2)
SEED = 3
# name, depth, mean bar, exact (max |Δ| < 1e-5)
TEXTURED = [("perlin_sphere", 3, 1e-3, False), ("simple_light", 4, 1e-3, False),
            ("earth", 3, 1e-3, True)]


def _launch(name, depth):
    """The JAX scene at width 32, spp 1, and one 1024-multiple block of its
    camera rays (made by the port, whose camera equals the JAX package's;
    tests/test_torch_core.py) as CPU tensors."""
    sj, cfg = jbuild(name, image_width=32, samples_per_pixel=1, max_depth=depth)
    n = -(-cfg.n_pixels // 1024) * 1024
    pix = torch.clamp(torch.arange(n, dtype=torch.int32), max=cfg.n_pixels - 1)
    smp = torch.zeros(n, dtype=torch.int32)
    cfg_p = pcam.CameraConfig(**vars(cfg))
    o, d, tm = pcam.generate_rays(cfg_p, pcam.derive(cfg_p, pcam.CameraParams.from_config(
        cfg_p, "cpu")), pix, smp, SEED, motion_blur=sj.flags.has_moving)
    return sj, cfg, (o, d, tm, pix, smp)


@pytest.mark.parametrize("name,depth,mean_bar,exact", TEXTURED)
def test_plain_k1_matches_xla_integrator(name, depth, mean_bar, exact):
    before_mb = int(mb.launches)
    sj, cfg, rays = _launch(name, depth)
    bg = jnp.asarray(cfg.background, jnp.float32)
    rad_j, seg_j = jit_run(lambda *r: jtrace(sj, *r, bg, depth, jnp.uint32(SEED),
                                             hit_fn=closest_hit_brute, remat=False),
                           *(jnp.asarray(x.numpy()) for x in rays))
    mega = build_mega_scene(port_scene(sj))
    rad, seg = trace_megakernel(mega, *rays, cfg.background, depth, SEED, layout="block")
    assert int(mb.launches) == before_mb  # CPU tensors ran the plain version
    diff = np.abs(rad.numpy() - np.asarray(rad_j))
    assert diff.mean() < mean_bar, diff.mean()
    if exact:
        assert diff.max() < 1e-5, diff.max()
    assert segments_close(int(seg_j), int(seg)), (int(seg_j), int(seg))
    assert float(rad.sum()) > 0


@pytest.mark.parametrize("name,depth,mean_bar,exact", TEXTURED)
def test_plain_k5_matches_plain_k1(name, depth, mean_bar, exact):
    """K5's walk and dense sweep against K1 on the same rays: the shading
    is one function, the closest hits round alike up to a·t-space roots
    (K1) and t-space roots (K5). The walk equals the sweep bit for bit."""
    before_mg = int(mg.launches)
    sj, cfg, rays = _launch(name, depth)
    mega = build_mega_scene(port_scene(sj))
    args = (mega, *rays, cfg.background, depth, SEED)
    r1, s1 = trace_megakernel(*args, layout="block")
    r_walk, s_walk = trace_megakernel(*args, layout="group", use_bvh=True)
    r_sweep, s_sweep = trace_megakernel(*args, layout="group", use_bvh=False)
    assert int(mg.launches) == before_mg
    assert torch.equal(r_walk, r_sweep) and int(s_walk) == int(s_sweep)
    diff = (r_walk - r1).abs()
    assert float(diff.mean()) < mean_bar
    if exact:
        assert float(diff.max()) < 1e-5
    assert segments_close(int(s1), int(s_walk))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_renderer_renders_every_registry_scene(name):
    """Every scene of the registry renders through the megakernels, the
    textured ones included: a finite image and segments."""
    scene, cfg = build(name, device="cpu", image_width=16, samples_per_pixel=1, max_depth=3)
    res = Renderer(cfg).render(scene, seed=SEED)
    assert res.radiance.shape == (cfg.image_height, cfg.image_width, 3)
    assert np.isfinite(res.radiance).all() and res.segments >= cfg.n_pixels


def test_texels_and_sphere_uv_do_not_depend_on_threads_or_order():
    """The plain versions' image texels (K1's and K5's ``image_texel``) and
    the integrator's sphere UV (``hit_attributes``) on earth's globe are bit
    for bit the same at 1, 2 and 8 threads and under a permutation of the
    points: they take atan2 through ``atan2_rn``, where PyTorch's CPU
    float32 atan2 depends on the thread count and on an element's place in
    the tensor (an odd count of 70,001 points leaves a vector tail)."""
    scene, _ = build("earth", device="cpu", image_width=32, samples_per_pixel=1)
    mega = build_mega_scene(scene)
    n = 70_001
    rng = np.random.default_rng(9)
    own = rng.normal(size=(n, 3))
    own /= np.linalg.norm(own, axis=1, keepdims=True)
    own[:4] = [(0.0, 1.0, 0.0), (0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (-1.0, 0.0, -0.0)]
    own = torch.from_numpy(own.astype(np.float32))
    p = own * scene.spheres.radius[0] + scene.spheres.center[0]
    zeros = torch.zeros(n)
    ids = torch.zeros(n, dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(n))

    def run(threads, order):
        torch.set_num_threads(threads)
        try:
            pp, oo = p[order], own[order]
            texel = mb.image_texel(mega, ids.long(), *pp.unbind(1), *oo.unbind(1))
            hit = hit_attributes(scene, pp, -oo, zeros, zeros, ids)
            out = (*texel, hit.u, hit.v)
        finally:
            torch.set_num_threads(2)
        inv = torch.argsort(order)
        return [x[inv] for x in out]

    ref = run(1, torch.arange(n))
    for threads, order in ((2, torch.arange(n)), (8, torch.arange(n)), (1, perm), (8, perm)):
        for x, y in zip(run(threads, order), ref):
            assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                               y.view(torch.int32) if y.is_floating_point() else y)
