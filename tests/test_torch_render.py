"""The port's forward render end to end on the CPU: the phased megakernel
Renderer against the JAX XLA wavefront integrator, and the invariants of
the phase schedule and of the prefix plan."""
import numpy as np
import pytest
import torch

from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.render.renderer import Renderer as JRenderer
from raytracing_tpu_torch import Renderer, build
from raytracing_tpu_torch.core.color import to_u8_image
from torch_parity import segments_close

torch.set_num_threads(2)
SEED = 5


def test_render_matches_xla_integrator():
    """bouncing_spheres (checker, motion blur, metal, glass), 32 px wide,
    2 spp, depth 7: radiance mean |Δ| < 2e-3, segments within max(4, s/200)."""
    kw = dict(image_width=32, samples_per_pixel=2, max_depth=7)
    sj, cfg_j = jbuild("bouncing_spheres", **kw)
    ref = JRenderer(cfg_j, hit_method="brute", mode="while").render(sj, seed=SEED)
    scene, cfg = build("bouncing_spheres", device="cpu", **kw)
    out = Renderer(cfg, hit_method="mega", phase_depths=[2, 2, 3]).render(scene, seed=SEED)
    assert out.radiance.shape == ref.radiance.shape
    assert np.abs(out.radiance - ref.radiance).mean() < 2e-3
    assert segments_close(ref.segments, out.segments), (ref.segments, out.segments)
    u8 = Renderer(cfg, hit_method="mega", phase_depths=[2, 2, 3], transfer="u8").render(
        scene, seed=SEED)
    assert u8.radiance is None and u8.segments == out.segments
    np.testing.assert_array_equal(u8.u8, to_u8_image(torch.from_numpy(out.radiance)).numpy())
    np.testing.assert_array_equal(u8.image_u8, out.image_u8)


@pytest.mark.parametrize("name", ["bouncing_spheres", "cornell_box"])
def test_phased_equals_single_phase(name):
    scene, cfg = build(name, device="cpu", image_width=32, samples_per_pixel=2, max_depth=7)
    one = Renderer(cfg, phase_depths=[7]).render(scene, seed=SEED)
    ph = Renderer(cfg, phase_depths=[2, 2, 3]).render(scene, seed=SEED)
    assert one.segments == ph.segments
    assert np.abs(one.radiance - ph.radiance).max() < 1e-5


def test_planned_prefixes_are_exact_and_undersized_raise():
    scene, cfg = build("bouncing_spheres", device="cpu", image_width=64, samples_per_pixel=2,
                       max_depth=7)
    kw = dict(phase_depths=[2, 2, 3], transfer="u8")
    base = Renderer(cfg, **kw).render(scene, seed=SEED)
    r = Renderer(cfg, **kw)
    pref = r.plan_phase_prefixes(scene, seed=SEED, margin_blocks=0)
    B = r.n_block * r.spp_chunk
    assert pref[0] is None and min(pref[1:]) < B  # the tail phases really shrink
    res = Renderer(cfg, **kw, phase_prefixes=pref).render(scene, seed=SEED)
    assert res.ok is True
    assert res.segments == base.segments
    np.testing.assert_array_equal(res.u8, base.u8)
    k = max(range(1, len(pref)), key=lambda i: pref[i])
    small = list(pref)
    small[k] -= 1024
    with pytest.raises(RuntimeError, match="phase_prefixes exceeded"):
        Renderer(cfg, **kw, phase_prefixes=small).render(scene, seed=SEED)
    flagged = Renderer(cfg, **kw, phase_prefixes=small, strict_prefixes=False).render(
        scene, seed=SEED)
    assert flagged.ok is False
