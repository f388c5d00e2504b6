"""The fused single dispatch on the CPU: ``Renderer(fused=True)``, the
fused prefix plan and the fused fwd+bwd sweep run their launch program
(``render/graphs.py``) once a launch, eagerly, and must equal the launch
loop (``fused=False``) bit for bit. On a card the same program is a CUDA
graph (``chip_smoke.py`` phase 32, ``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from raytracing_tpu_torch import Renderer, build
from raytracing_tpu_torch import bench as pbench
from raytracing_tpu_torch.render import graphs
from raytracing_tpu_torch.render.camera import CameraConfig
from raytracing_tpu_torch.scene.builder import SceneBuilder
from torch_parity import bilinear_grid

torch.set_num_threads(2)
SEED = 5
# 64 px wide, 2 spp, depth 6: launches of 2048 rays, two pixel blocks by
# two sample chunks, whose planned prefix after one bounce is a whole
# launch (so one block less undersizes it)
SMALL = dict(image_width=64, samples_per_pixel=2, max_depth=6)
LAUNCH = dict(max_rays_per_launch=2048, phase_depths=[1, 2, 3])


def _equal(a, b):
    assert a.launches == b.launches and a.segments == b.segments and a.ok == b.ok
    for x, y in ((a.radiance, b.radiance), (a.u8, b.u8)):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _both(cfg, scene, **kw):
    """(fused, loop) results of one render, and the fused renderer."""
    fused = Renderer(cfg, **LAUNCH, **kw)
    out = fused.render(scene, seed=SEED)
    return out, Renderer(cfg, **LAUNCH, **kw, fused=False).render(scene, seed=SEED), fused


@pytest.mark.parametrize("name,method", [("three_spheres", "mega"), ("cornell_box", "mega"),
                                         ("bouncing_spheres", "mega"),
                                         ("three_spheres", "brute"),
                                         ("bouncing_spheres", "bvh")])
def test_fused_render_equals_loop(name, method):
    """f32 radiance, u8 bytes, segments, ok and launches, bit for bit,
    without prefixes, with planned ones and with undersized ones (which
    raise in both with ``strict_prefixes``, held on cornell_box)."""
    scene, cfg = build(name, device="cpu", **SMALL)
    fused, loop, r = _both(cfg, scene, hit_method=method)
    _equal(fused, loop)
    assert fused.launches == 4 and fused.ok is None and r.programs.program is not None
    if method != "mega":
        return
    pref = Renderer(cfg, **LAUNCH).plan_phase_prefixes(scene, seed=SEED, margin_blocks=0)
    fused, loop, _ = _both(cfg, scene, transfer="u8", phase_prefixes=pref)
    _equal(fused, loop)
    assert fused.ok is True and fused.radiance is None
    assert pref[1] == 2048
    small = (None, 1024, pref[2])
    for f in (True, False) if name == "cornell_box" else ():
        with pytest.raises(RuntimeError, match="phase_prefixes exceeded"):
            Renderer(cfg, **LAUNCH, phase_prefixes=small, fused=f).render(scene, seed=SEED)
    fused, loop, _ = _both(cfg, scene, phase_prefixes=small, strict_prefixes=False)
    _equal(fused, loop)
    assert fused.ok is False


def test_fused_auto_bvh_equals_loop():
    """``"auto"`` on a scene the megakernels cannot express, with a BVH
    over more than 64 primitives, takes the BVH integrator and renders it
    through the launch program, bit for bit with the loop."""
    cfg = CameraConfig(aspect_ratio=1.0, image_width=48, samples_per_pixel=2, max_depth=3,
                       vfov=30.0, lookfrom=(0.0, 1.5, 6.0), lookat=(0.0, 0.3, 0.0),
                       background=(0.7, 0.8, 1.0))
    scene = bilinear_grid(SceneBuilder()).compile(device="cpu", image_bilinear=True)
    fused, loop, r = _both(cfg, scene)
    assert r.resolve_hit_method(scene) == "bvh" and r.programs.program is not None
    _equal(fused, loop)
    assert fused.launches == 4 and 0.05 < float(fused.radiance.mean()) < 1.0


def test_fused_resume_equals_whole_render_and_progress_takes_the_loop(capsys):
    """A fused render resumed from sample chunk k equals the whole render;
    ``progress`` and ``checkpoint_cb`` take the loop (no program built)."""
    scene, cfg = build("three_spheres", device="cpu", **SMALL)
    whole = Renderer(cfg, **LAUNCH).render(scene, seed=SEED)
    states = []
    looped = Renderer(cfg, **LAUNCH)
    _equal(looped.render(scene, seed=SEED, checkpoint_cb=states.append), whole)
    assert looped.programs.program is None and len(states) == 2
    for k in (1, 2):  # at 2 nothing is left to replay
        r = Renderer(cfg, **LAUNCH)
        res = r.render(scene, seed=SEED, resume_state=states[k - 1])
        assert res.launches == 2 * (2 - k) and res.segments == whole.segments
        np.testing.assert_array_equal(res.radiance, whole.radiance)
        assert r.programs.program is not None
    shown = Renderer(cfg, **LAUNCH)
    _equal(shown.render(scene, seed=SEED, progress=True), whole)
    assert shown.programs.program is None and "Done." in capsys.readouterr().out


def test_fused_plan_equals_loop_and_histogram_equals_bincount():
    scene, cfg = build("bouncing_spheres", device="cpu", **SMALL)
    kw = dict(seed=SEED, margin_blocks=0)
    pref = Renderer(cfg, **LAUNCH).plan_phase_prefixes(scene, **kw)
    assert pref == Renderer(cfg, **LAUNCH, fused=False).plan_phase_prefixes(scene, **kw)
    assert pref == (None, 2048, 1024)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 9, 5000))
    assert torch.equal(graphs.histogram(x, 12), torch.bincount(x, minlength=12))


def test_fused_sweep_equals_loop():
    """``bench``'s fwd+bwd sweep at width 32, spp 4, depth 5, two chunks of
    two samples: plans equal; loss, segments, ok and gradients bit-equal."""
    s = pbench._fwd_bwd_setup(width=32, spp=4, max_depth=5, seed=7, spp_chunk=2, device="cpu")
    pref = s["plan"](fused=True)
    assert pref == s["plan"](fused=False)
    fused = s["sweep"](fused=True)
    loop = s["sweep"](fused=False)
    assert s["programs"].program is not None and bool(fused[4]) and int(fused[3]) > 0
    for a, b in zip(fused, loop):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float(fused[2].abs().sum()) > 0
    t = pbench.time_fwd_bwd(s, reps=1)
    assert t["segments"] == int(loop[3]) and t["grads_finite"]
    assert torch.equal(t["grad_rgb"], loop[2])
