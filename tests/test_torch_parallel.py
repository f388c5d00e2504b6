"""The port's multi-device renderer (``raytracing_tpu_torch/parallel/``) on
4 gloo ranks on the CPU, against its single-device render and once
against the JAX package's ``render_sharded``.

One module-scoped spawn (``parallel.mesh.spawn``: the spawn start method,
a ``FileStore``, no network) runs every mode on each rank
(``entry.sharded_modes``: three_spheres, 16 px, 4 spp, depth 3, seed 5,
the shapes of ``tests/test_parallel.py`` and ``tests/test_pp.py``) and
returns the results; the tests only compare. The bars are the JAX tests':
dp bit-equal with equal segments; sp, tp and the ring within atol 1e-5;
per-range BVHs with fewer than 0.2% outlier pixels; the pipeline
bit-equal; the per-bounce gradient all-reduce within rtol 1e-5, atol 1e-6
of the plain one; a resumed windowed render bit-equal to the
uninterrupted one. Against JAX: the parity bar, mean |Δ| < 1e-3.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu_torch import Renderer, build, render
from raytracing_tpu_torch.entry import sharded_modes
from raytracing_tpu_torch.parallel import mesh as pmesh
from raytracing_tpu_torch.render import camera as cam_mod
from raytracing_tpu_torch.render.camera import CameraParams
from raytracing_tpu_torch.render.integrator import trace

torch.set_num_threads(2)
SEED = 5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of ``sharded_modes`` on 4 gloo ranks."""
    return pmesh.spawn(sharded_modes, 4, backend="gloo", device="cpu",
                       args=(str(tmp_path_factory.mktemp("ranks")),))


@pytest.fixture(scope="module")
def modes(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def small():
    return build("three_spheres", device="cpu", image_width=16, samples_per_pixel=4,
                 max_depth=3)


@pytest.fixture(scope="module")
def reference(small):
    scene, cfg = small
    return render(scene, cfg, seed=SEED, hit_method="brute")


def test_dp4_bit_identical(modes, reference):
    img, segs = modes["dp4"]
    np.testing.assert_array_equal(img, reference.radiance)
    assert segs == reference.segments


def test_dp_sp_mesh(modes, reference):
    img, segs = modes["dp2sp2"]
    np.testing.assert_allclose(img, reference.radiance, atol=1e-5)
    assert segs == reference.segments


@pytest.mark.parametrize("method", ["brute", "ring"])
def test_tp_scene_sharded(modes, reference, method):
    """The all-reduce MIN closest hit and the ring give the single-device
    render's hits."""
    img, segs = modes[f"dp2tp2_{method}"]
    np.testing.assert_allclose(img, reference.radiance, atol=1e-5)
    assert segs == reference.segments


def test_tp_sharded_bvh_subtrees(modes, reference):
    """Each tp range walks its own BVH over Morton-ordered primitives: rare
    exact ties may flip."""
    img, _ = modes["dp2tp2_bvh"]
    diff = np.abs(img - reference.radiance).max(axis=-1)
    assert (diff > 1e-4).mean() < 0.002, f"outliers {(diff > 1e-4).mean()}"


def test_megakernel_under_dp(modes, small):
    """hit_method='mega': each rank runs K1 (its plain version on CPU
    tensors) on its launches, bit-equal to the single-device megakernel
    render with the same segments."""
    scene, cfg = small
    ref = Renderer(cfg, hit_method="mega").render(scene, seed=SEED)
    img, segs = modes["dp4_mega"]
    np.testing.assert_array_equal(img, ref.radiance)
    assert segs == ref.segments


def test_ranks_agree(ranks):
    """Every rank returns the same image and segments."""
    for r in ranks[1:]:
        for k in ("dp4", "dp2sp2", "dp2tp2_brute", "dp2tp2_ring", "dp2tp2_bvh", "dp4_mega"):
            np.testing.assert_array_equal(r[k][0], ranks[0][k][0])
            assert r[k][1] == ranks[0][k][1]
        np.testing.assert_array_equal(r["grad_overlap"], ranks[0]["grad_overlap"])


def _reference_stream(name, width, spp, depth):
    """The sample-major padded ray stream the pipeline renders, traced by
    the single-device integrator (``tests/test_pp.py``)."""
    scene, cfg = build(name, device="cpu", image_width=width, samples_per_pixel=spp,
                       max_depth=depth)
    B = -(-cfg.n_pixels // 1024) * 1024
    lane = torch.arange(B * spp)
    pix = torch.clamp(lane % B, max=cfg.n_pixels - 1)
    smp = torch.div(lane, B, rounding_mode="floor")
    derived = cam_mod.derive(cfg, CameraParams.from_config(cfg, "cpu"))
    o, d, t = cam_mod.generate_rays(cfg, derived, pix, smp, SEED,
                                    motion_blur=scene.flags.has_moving)
    with torch.no_grad():
        return trace(scene, o, d, t, pix, smp, cfg.background, cfg.max_depth, SEED,
                     active0=(lane % B) < cfg.n_pixels)


@pytest.mark.parametrize("key,name,width,spp,depth", [
    ("pp2_three_spheres_d6", "three_spheres", 16, 4, 6),
    ("pp4_three_spheres_d7", "three_spheres", 16, 4, 7),
    ("pp2_simple_light_d5", "simple_light", 16, 2, 5),
])
def test_pp_matches_single_device(modes, key, name, width, spp, depth):
    """Bounce windows staged over 2 or 4 ranks (2: on a dp2×pp2 mesh),
    microbatches streaming: every path's radiance bit-identical to the
    single-device integrator, the same segments."""
    rad, segs, n_micro = modes[key]
    rad_ref, segs_ref = _reference_stream(name, width, spp, depth)
    assert segs == int(segs_ref)
    np.testing.assert_array_equal(rad, rad_ref.numpy())
    assert n_micro > 1


def test_overlapped_grad_psum_identical(modes):
    """The per-bounce gradient all-reduce gives the gradient of the plain
    backward (one all-reduce at the scene input)."""
    g_plain, g_overlap = modes["grad_plain"], modes["grad_overlap"]
    assert np.abs(g_plain).max() > 0
    np.testing.assert_allclose(g_overlap, g_plain, rtol=1e-5, atol=1e-6)


def test_grad_through_sharded_render(modes, small):
    """The albedo gradient of a dp1×tp2×sp2 render equals the single-device
    ``render_once`` gradient (``tests/test_parallel.py``'s bar)."""
    from raytracing_tpu_torch.diff.gradients import render_once

    scene, cfg = small
    g_sharded = modes["grad_dp1tp2sp2"]
    rgb = scene.textures.rgb.clone().requires_grad_(True)
    s = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, rgb=rgb))
    torch.mean(render_once(s, cfg, seed=0, remat=False)).backward()
    g_single = rgb.grad.numpy()
    assert np.isfinite(g_sharded).all() and np.abs(g_sharded).max() > 0
    scale = max(np.abs(g_single).max(), 1e-6)
    np.testing.assert_allclose(g_sharded / scale, g_single / scale, atol=5e-4)


def test_windows_checkpoint_and_resume(modes, reference):
    """Sample windows of 2 with a checkpoint after each: a render stopped
    after window 0 leaves ``next_window`` 1, and its resumption renders
    window 1 only and equals the uninterrupted windowed render bit for bit;
    both equal the whole render to float32 association."""
    w = modes["windows"]
    assert w["next_window"] == 1 and w["resumed_windows"] == [1]
    np.testing.assert_array_equal(w["resumed"][0], w["whole"][0])
    assert w["resumed"][1] == w["whole"][1] == reference.segments
    np.testing.assert_allclose(w["whole"][0], reference.radiance, rtol=0, atol=1e-6)


def test_dryrun_multichip_body(modes):
    """``dryrun_multichip``'s body on 4 ranks (dp1×tp2×sp2): one Adam step
    with the per-bounce all-reduce, the megakernel under dp×sp, the
    per-range BVH and a 2-stage pipeline."""
    d = modes["dryrun"]
    assert (d["dp"], d["tp"], d["sp"]) == (1, 2, 2)
    assert np.isfinite(d["loss"]) and d["update_norm"] > 0
    assert d["mega_segments"] > 0 and d["bvh_segments"] > 0 and d["pp_segments"] > 0


def test_dp2_sp2_matches_jax_render_sharded(modes):
    """The port's dp2×sp2 render against the JAX ``render_sharded`` on a
    (2, 2) mesh of the virtual CPU devices, at the parity bar."""
    from raytracing_tpu.models.scenes import build as jbuild
    from raytracing_tpu.parallel.mesh import make_mesh as jmake_mesh
    from raytracing_tpu.parallel.shard import render_sharded as jrender_sharded

    if len(jax.devices()) < 4:
        pytest.fail("the JAX comparison needs 4 virtual CPU devices (tests/conftest.py)")
    scene, cfg = jbuild("three_spheres", image_width=16, samples_per_pixel=4, max_depth=3)
    ref, segs_ref = jrender_sharded(scene, cfg, jmake_mesh((2, 2), ("dp", "sp")), seed=SEED)
    img, segs = modes["dp2sp2"]
    assert float(np.abs(img - np.asarray(ref)).mean()) < 1e-3
    assert abs(segs - int(segs_ref)) <= max(4, int(segs_ref) // 200)
    assert jnp.isfinite(jnp.asarray(ref)).all()


def test_backend_refusals(monkeypatch):
    """NCCL asked for more ranks than cards raises naming gloo; the
    default backend is NCCL only with a card a rank; the mesh needs a
    process group; no arguments and no RANK/WORLD_SIZE means a
    single-process run."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [pmesh.default_backend("cuda", n) for n in (1, 2)] == ["nccl", "gloo"]
    assert pmesh.default_backend("cpu", 1) == "gloo"
    with pytest.raises(ValueError, match="gloo"):
        pmesh.check_backend("nccl", 2, "cuda")
    with pytest.raises(ValueError, match="gloo"):
        pmesh.check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match="nccl"):
        pmesh.check_backend("mpi", 1, "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh((1,), device="cpu")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pmesh.initialize_distributed(device="cpu") is False
    with pytest.raises(ValueError, match="gloo"):
        pmesh.spawn(sharded_modes, 2, backend="nccl", device="cpu", args=(os.getcwd(),))
