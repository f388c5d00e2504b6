"""The plain reference against the port on the CPU at small sizes, and the
lower-precision control against the reference."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.common import compare
from benchmark.reference import rng, tracer
from small import ROOT

CONFIGS = ("bouncing_spheres", "cornell_box")


def _config(name):
    return tracer.load_config(ROOT / "benchmark" / "configs" / f"{name}.json")


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import benchmark.reference.tracer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'raytracing_tpu', 'raytracing_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("name", CONFIGS)
def test_recipe_tables_equal_the_port_registry(name):
    from raytracing_tpu_torch.models.scenes import build

    conf, arr = _config(name)
    scene, cfg = build(conf["port_scene"], device="cpu")
    ns, nq = len(arr["sph_radius"]), len(arr["quad_mat"])
    assert conf["primitives"] == {"spheres": ns, "quads": nq}
    pairs = [(scene.spheres.center[:ns], arr["sph_center"]),
             (scene.spheres.velocity[:ns], arr["sph_velocity"]),
             (scene.spheres.radius[:ns], arr["sph_radius"]),
             (scene.spheres.mat_id[:ns], arr["sph_mat"]),
             (scene.quads.q[:nq], arr["quad_q"]), (scene.quads.u[:nq], arr["quad_u"]),
             (scene.quads.v[:nq], arr["quad_v"]), (scene.quads.mat_id[:nq], arr["quad_mat"]),
             (scene.materials.mtype, arr["mat_type"]), (scene.materials.tex_id, arr["mat_tex"]),
             (scene.materials.fuzz, arr["mat_fuzz"]), (scene.materials.ior, arr["mat_ior"]),
             (scene.textures.ttype, arr["tex_type"]), (scene.textures.rgb, arr["tex_rgb"]),
             (scene.textures.scale, arr["tex_scale"]), (scene.textures.child, arr["tex_child"])]
    for port, ref in pairs:
        np.testing.assert_array_equal(port.numpy(), ref)
    cam = conf["camera"]
    for key in ("vfov", "lookfrom", "lookat", "vup", "defocus_angle", "focus_dist", "background",
                "aspect_ratio"):
        assert np.allclose(getattr(cfg, key), cam[key]), key


def test_pcg4d_equals_the_port():
    from raytracing_tpu_torch.core import rng as port_rng

    g = torch.Generator().manual_seed(3)
    words = [torch.randint(-2**40, 2**40, (4096,), generator=g) for _ in range(4)]
    for a, b in zip(rng.pcg4d(*words), port_rng.pcg4d(*words)):
        assert torch.equal(a, b)
    pix, smp = words[0].abs() % 10**6, words[1].abs() % 500
    assert torch.equal(rng.uniforms(pix, smp, 6, 2**33 + 5),
                       port_rng.uniform4(pix, smp, 6, (2**33 + 5) & 0xFFFFFFFF))


def test_culled_search_equals_brute_force():
    """The search by groups finds every ray's winner and root as the test of
    every sphere does: camera rays, rays from sphere surfaces (roots near
    T_MIN, rays that start inside a box) and random rays over the grid."""
    conf, arr = _config("bouncing_spheres")
    sc = tracer.Scene(arr, "cpu")
    assert sc.groups is not None and tracer.Scene(arr, "cpu", torch.bfloat16).groups is None
    cam = tracer.Camera(conf["camera"], 160, "cpu")
    g = torch.Generator().manual_seed(5)
    n = 30_000
    o, d, tm = cam.rays(torch.randint(0, cam.width * cam.height, (n,), generator=g),
                        torch.randint(0, 500, (n,), generator=g), 2**31 - 3, True)
    sid = torch.randint(0, sc.n_sph, (n,), generator=g)
    out = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    o2 = sc.center[sid] + out * sc.radius[sid, None]
    o3 = torch.rand(n, 3, generator=g) * torch.tensor([24.0, 2.0, 24.0]) - torch.tensor(
        [12.0, 0.0, 12.0])
    O, D = torch.cat([o, o2, o3]), torch.cat([d, torch.randn(2 * n, 3, generator=g)])
    T = torch.cat([tm, torch.rand(2 * n, generator=g)])
    culled = tracer.closest(sc, O, D, T)
    sc.groups = None
    brute = tracer.closest(sc, O, D, T)
    assert (culled[0] >= 0).sum() > n
    for a, b in zip(culled, brute):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,width,spp,depth", [("bouncing_spheres", 48, 4, 8),
                                                  ("cornell_box", 24, 4, 12)])
def test_reference_render_equals_the_port(name, width, spp, depth):
    from raytracing_tpu_torch import Renderer
    from raytracing_tpu_torch.models.scenes import build

    conf, arr = _config(name)
    seed = compare.render_seed(2**41 + 3)
    scene, cfg = build(conf["port_scene"], device="cpu", image_width=width,
                       samples_per_pixel=spp, max_depth=depth)
    res = Renderer(cfg).render(scene, seed=seed)
    cam = tracer.Camera(conf["camera"], width, "cpu")
    rad, segs = tracer.render_pixels(tracer.Scene(arr, "cpu"), cam, torch.arange(cfg.n_pixels),
                                     spp, depth, seed)
    assert int(segs.sum()) == res.segments
    assert np.abs(res.radiance.reshape(-1, 3) - rad.numpy()).max() < 1e-5


def test_reference_sweep_equals_the_port():
    from raytracing_tpu_torch import bench
    from raytracing_tpu_torch.render import graphs

    width, spp, depth, chunk = 40, 8, 6, 4
    seed = compare.render_seed(2**41 + 5)
    s = bench._fwd_bwd_setup(width=width, spp=spp, max_depth=depth, seed=seed, spp_chunk=chunk,
                             device="cpu")
    s["plan"](fused=True)
    loss, gc, gr, segs, ok = graphs.to_host(*s["sweep"](fused=True))
    conf, arr = _config("bouncing_spheres")
    ref = tracer.grad_sweep(tracer.Scene(arr, "cpu"), tracer.Camera(conf["camera"], width, "cpu"),
                            spp, chunk, depth, seed)
    nums = compare.grad_numbers(float(loss), gc, gr, int(segs), bool(ok), float(ref[0]),
                                ref[1].numpy(), ref[2].numpy(), ref[3])
    assert nums["loss_rel"] < 1e-6 and nums["segments_rel"] == 0.0
    assert nums["grad_rel_l2"] < 5e-3


@pytest.mark.parametrize("cell", ["bouncing_spheres.final_render", "cornell_box.render",
                                  "bouncing_spheres.grad_sweep"])
def test_bfloat16_control_fails_the_limits(cell):
    """The reference computed in bfloat16 in the program's place, at a small
    size: it fails one of the cell's limits at least."""
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
    config = cell.split(".")[0]
    conf, arr = _config(config)
    seed = compare.render_seed(2**42 + 11)
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        sc = tracer.Scene(arr, "cpu", dtype)
        cam = tracer.Camera(conf["camera"], 32, "cpu", dtype)
        if "grad" in cell:
            runs[dtype] = tracer.grad_sweep(sc, cam, 8, 4, 6, seed)
        else:
            runs[dtype] = tracer.render_pixels(sc, cam, torch.arange(cam.width * cam.height),
                                               4, 8, seed)
    ref, low = runs[torch.float32], runs[torch.bfloat16]
    if "grad" in cell:
        nums = compare.grad_numbers(float(low[0]), low[1].numpy(), low[2].numpy(), low[3], True,
                                    float(ref[0]), ref[1].numpy(), ref[2].numpy(), ref[3])
    else:
        n = ref[0].shape[0]
        nums = compare.render_numbers(low[0].numpy(), int(low[1].sum()), True, ref[0].numpy(),
                                      ref[1].numpy(), n)
    assert any(nums[k] > limits[k] for k in limits), nums


@pytest.mark.cuda
@pytest.mark.parametrize("cell,width,spp", [("bouncing_spheres.final_render", 240, 20),
                                            ("cornell_box.render", 120, 20),
                                            ("bouncing_spheres.grad_sweep", 160, 8),
                                            ("bouncing_spheres.final_grad", 160, 8)])
def test_bfloat16_control_fails_on_the_card(cell, width, spp):
    """As above on the card at a size a test can hold, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
    conf, arr = _config(cell.split(".")[0])
    mix = json.loads((ROOT / "benchmark" / "traffic" / f"{cell.split('.')[1]}.json").read_text())
    dev = torch.device("cuda", 0)
    for s in range(3):
        seed = compare.render_seed(2**43 + s)
        runs = {}
        for dtype in (torch.float32, torch.bfloat16):
            sc = tracer.Scene(arr, dev, dtype)
            cam = tracer.Camera(conf["camera"], width, dev, dtype)
            if "grad" in cell:
                runs[dtype] = tracer.grad_sweep(sc, cam, spp, 4, mix["max_depth"], seed)
            else:
                px = torch.arange(cam.width * cam.height)
                runs[dtype] = tracer.render_pixels(sc, cam, px, spp, mix["max_depth"], seed)
        ref, low = runs[torch.float32], runs[torch.bfloat16]
        if "grad" in cell:
            nums = compare.grad_numbers(float(low[0]), low[1].cpu().numpy(),
                                        low[2].cpu().numpy(), low[3], True, float(ref[0]),
                                        ref[1].cpu().numpy(), ref[2].cpu().numpy(), ref[3])
        else:
            nums = compare.render_numbers(low[0].cpu().numpy(), int(low[1].sum()), True,
                                          ref[0].cpu().numpy(), ref[1].cpu().numpy(),
                                          ref[0].shape[0])
        assert any(nums[k] > limits[k] for k in limits), nums

