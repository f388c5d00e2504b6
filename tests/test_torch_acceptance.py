"""The port's acceptance run (``raytracing_tpu_torch/acceptance.py``) and
C++ comparison (``raytracing_tpu_torch/cpp_compare.py``) on the CPU.

Configs 1 and 2 at the smoke scale (``--scale 0.125``) against the JAX
package's integrator render of the same configuration (compiled with
``jit_run``), at the parity bar (mean |Δ| < 1e-3, segments within
max(4, s/200)); the cheapest stored C++ configuration (quads, 128 px, 32
spp) against ``CPP_COMPARE.json`` under its own tolerances; and the
copies of the JAX tools' tables.
"""
import functools
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.ops.intersect import closest_hit_brute as jbrute
from raytracing_tpu.render import camera as jcam
from raytracing_tpu.render.renderer import _render_chunk as jrender_chunk
from raytracing_tpu_torch import Renderer, acceptance, build, cpp_compare
from torch_parity import jit_run, segments_close

torch.set_num_threads(2)
SEED = 7
TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def _jax_render(c):
    """The JAX integrator's render of configuration ``c`` (its brute-force
    ``_render_chunk`` over the whole image): mean radiance and segments."""
    scene, cfg = jbuild(c["scene"], image_width=c["width"], samples_per_pixel=c["spp"],
                        max_depth=c["depth"])
    n_block = -(-cfg.n_pixels // 1024) * 1024
    fn = functools.partial(jrender_chunk, cfg=cfg, n_block=n_block,
                           spp_chunk=cfg.samples_per_pixel, hit_fn=jbrute, mode="scan",
                           remat=False)
    rad, seg = jit_run(fn, scene, jcam.CameraParams.from_config(cfg), jnp.int32(0),
                       jnp.int32(0), jnp.uint32(SEED))
    mean = np.asarray(rad)[:cfg.n_pixels] / cfg.samples_per_pixel
    return mean.reshape(cfg.image_height, cfg.image_width, 3), int(seg)


def test_tables_are_the_jax_tools():
    """``CONFIGS`` and ``_scaled`` are ``tools/acceptance.py``'s; the C++
    configurations and tolerances are ``tools/cpp_compare.py``'s and the
    stored file's."""
    sys.path.insert(0, TOOLS)
    try:
        import acceptance as jacc
        import cpp_compare as jcpp
    finally:
        sys.path.remove(TOOLS)
    assert acceptance.CONFIGS == jacc.CONFIGS
    for n, c in jacc.CONFIGS.items():
        for scale in (1.0, 0.125, 0.25):
            assert acceptance._scaled(c, scale) == jacc._scaled(c, scale)
    assert cpp_compare.CONFIGS == jcpp.CONFIGS and cpp_compare.QUICK == jcpp.QUICK
    assert cpp_compare.SCENE_IDS == jcpp.SCENE_IDS
    stored = cpp_compare.stored()
    for scene, w, spp, d, mtol, nbtol in cpp_compare.CONFIGS:
        assert stored[(scene, w, spp, d)]["tol"] == dict(mean=mtol, nonblack=nbtol)


@pytest.mark.parametrize("n", [1, 2])
def test_smoke_config_matches_jax(n):
    """The port's acceptance statistics of a smoke-scale config are those
    of its default ``Renderer`` render, which matches the JAX integrator's
    render of the same configuration."""
    c = acceptance._scaled(acceptance.CONFIGS[n], 0.125)
    out = acceptance.run_config(n, c, seed=SEED, reps=1, device="cpu")
    scene, cfg = build(c["scene"], device="cpu", image_width=c["width"],
                       samples_per_pixel=c["spp"], max_depth=c["depth"])
    res = Renderer(cfg).render(scene, seed=SEED)
    ref, ref_seg = _jax_render(c)
    assert res.radiance.shape == ref.shape
    assert float(np.abs(res.radiance - ref).mean()) < 1e-3
    assert segments_close(ref_seg, res.segments), (ref_seg, res.segments)
    u8 = res.image_u8
    assert out["segments"] == res.segments
    assert out["mean_u8"] == [round(float(m), 2) for m in u8.mean(axis=(0, 1))]
    assert out["nonblack_frac"] == round(float((u8.sum(-1) > 10).mean()), 4)
    assert out["hit_method"] == "mega" and out["card"] == "cpu"
    json.dumps(out)


def test_acceptance_fails_loudly(monkeypatch):
    """A configuration that raises ends the run with that error; nothing
    is printed as a result."""
    def boom(*a, **k):
        raise RuntimeError("config failed")

    monkeypatch.setattr(acceptance, "run_config", boom)
    with pytest.raises(RuntimeError, match="config failed"):
        acceptance.main(["--configs", "1", "--device", "cpu"])


def test_cpp_compare_quads_within_stored_tolerance():
    """quads (128 px, 32 spp, depth 8) through the port's default
    ``Renderer`` against the C++ statistics ``CPP_COMPARE.json`` stores."""
    scene, w, spp, d, mtol, nbtol = cpp_compare.CONFIGS[0]
    r = cpp_compare.run_config(scene, w, spp, d, mtol, nbtol, device="cpu")
    assert r["cpp_source"] == "CPP_COMPARE.json"
    assert r["port"]["shape"] == r["cpp"]["shape"] == [128, 128]
    assert r["pass"], r


def test_cpp_aspect_quirk():
    """The C++ renderer's float32 aspect: 32 px at 16/9 is 17 rows, not 18,
    and the port renders that grid; 128 px is 71 rows, as stored."""
    img = cpp_compare.port_image("checkered_spheres", 32, 1, 2, device="cpu")
    assert img.shape == (17, 32, 3)
    _, cfg = build("checkered_spheres", device="cpu", image_width=32)
    assert cfg.image_height == 18
    assert cpp_compare.stored()[("checkered_spheres", 128, 32, 16)]["cpp"]["shape"] == [71, 128]
