"""The port's ``utils/`` and ``Renderer.render``'s checkpoint loop against
the JAX package: a resumed render equal to the whole one bit for bit, a
checkpoint written by one package resumed by the other, the refusals,
PPM files byte-equal to the JAX writer's, ``scene_stats`` and the logger,
``occupancy_histogram`` (at 1e-6), ``trace_to``, and the sanitizers as in
tests/test_sanitize.py."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.utils import checkpoint as jckpt
from raytracing_tpu.utils import image_io as jimage_io
from raytracing_tpu.utils.logging import scene_stats as jscene_stats
from raytracing_tpu.utils.profiling import occupancy_histogram as jocc
from raytracing_tpu_torch import Renderer, build
from raytracing_tpu_torch.diff.gradients import render_once
from raytracing_tpu_torch.ops.traverse import closest_hit_bvh
from raytracing_tpu_torch.scene.assets import read_ppm
from raytracing_tpu_torch.utils import checkpoint as ckpt
from raytracing_tpu_torch.utils import image_io
from raytracing_tpu_torch.utils.logging import JsonlLogger, scene_stats
from raytracing_tpu_torch.utils.profiling import annotate, occupancy_histogram, trace_to
from raytracing_tpu_torch.utils.sanitize import checked, nan_guard

torch.set_num_threads(2)
RESUME = dict(image_width=32, samples_per_pixel=8, max_depth=4)
MAX_RAYS = 32 * 16 * 2  # one 1024-pixel block, 1 sample a launch: 8 sample chunks


def _resume_renderer(hit_method):
    return Renderer(build("single_sphere", device="cpu", **RESUME)[1], hit_method=hit_method,
                    max_rays_per_launch=MAX_RAYS)


@pytest.mark.parametrize("hit_method", ["mega", "brute"])
def test_render_resume_identical(tmp_path, hit_method):
    """tests/test_utils.py's case, bit for bit: checkpoint every sample
    chunk, keep the second, save and load it, and resume in a new
    Renderer: the radiance and segments equal the whole render's."""
    scene, _ = build("single_sphere", device="cpu", **RESUME)
    full = _resume_renderer(hit_method).render(scene, seed=3)
    states = []
    again = _resume_renderer(hit_method).render(scene, seed=3, checkpoint_cb=states.append)
    np.testing.assert_array_equal(again.radiance, full.radiance)
    assert len(states) == RESUME["samples_per_pixel"] and full.launches == len(states)
    assert [s["schunk"] for s in states] == list(range(1, len(states) + 1))
    assert states[-1]["segments"] == full.segments
    assert not np.array_equal(states[1]["accum"], states[2]["accum"])  # copies, not views
    p = str(tmp_path / "ck.npz")
    ckpt.save_render_state(p, states[1])
    loaded = ckpt.load_render_state(p)
    assert loaded["schunk"] == 2 and loaded["segments"] == states[1]["segments"]
    resumed = _resume_renderer(hit_method).render(scene, seed=3, resume_state=loaded)
    np.testing.assert_array_equal(resumed.radiance, full.radiance)
    assert resumed.segments == full.segments and resumed.launches == len(states) - 2
    assert ckpt.load_render_state(str(tmp_path / "absent.npz")) is None


def test_checkpoint_crosses_packages(tmp_path):
    """A render state written by either package loads in the other, array
    for array; a state saved by the JAX writer resumes the port's render
    bit for bit."""
    scene, _ = build("single_sphere", device="cpu", **RESUME)
    states = []
    full = _resume_renderer("mega").render(scene, seed=3, checkpoint_cb=states.append)
    mid = states[3]
    p_jax, p_port = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_render_state(p_jax, mid)
    ckpt.save_render_state(p_port, mid)
    for a, b in ((ckpt.load_render_state(p_jax), jckpt.load_render_state(p_port)),
                 (ckpt.load_render_state(p_port), jckpt.load_render_state(p_jax))):
        np.testing.assert_array_equal(a["accum"], b["accum"])
        assert a["accum"].dtype == b["accum"].dtype == np.float32
        assert (a["segments"], a["schunk"]) == (b["segments"], b["schunk"])
    resumed = _resume_renderer("mega").render(scene, seed=3,
                                              resume_state=ckpt.load_render_state(p_jax))
    np.testing.assert_array_equal(resumed.radiance, full.radiance)
    assert resumed.segments == full.segments


def test_resume_refusals():
    """A state of another launch shape raises (the port's default launch is
    1<<18 rays, the JAX package's 1<<20); the pool schedule refuses
    ``resume_state`` and ``checkpoint_cb`` rather than ignoring them."""
    scene, cfg = build("single_sphere", device="cpu", **RESUME)
    states = []
    _resume_renderer("mega").render(scene, seed=3, checkpoint_cb=states.append)
    wrong = dict(states[0], accum=np.zeros((2048, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        _resume_renderer("mega").render(scene, seed=3, resume_state=wrong)
    with pytest.raises(ValueError, match="sample chunks"):
        _resume_renderer("mega").render(scene, seed=3, resume_state=dict(states[0], schunk=9))
    pool = Renderer(cfg, schedule="pool")
    with pytest.raises(ValueError, match="schedule='pool'"):
        pool.render(scene, seed=3, resume_state=states[0])
    with pytest.raises(ValueError, match="schedule='pool'"):
        pool.render(scene, seed=3, checkpoint_cb=states.append)


def test_state_dict_round_trip(tmp_path):
    """``save_state_dict``/``load_state_dict``: the counterparts of the JAX
    package's pytree checkpoints."""
    scene, _ = build("single_sphere", device="cpu")
    state = {"center": scene.spheres.center, "rgb": scene.textures.rgb,
             "mat_id": scene.spheres.mat_id}
    p = str(tmp_path / "sub" / "state.npz")
    ckpt.save_state_dict(p, state)
    back = ckpt.load_state_dict(p, device="cpu")
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and bool(torch.equal(back[k], v)), k


def test_ppm_byte_equal_jax(tmp_path, monkeypatch):
    """``write_ppm`` is byte-equal to the JAX package's on the same
    radiance, values at the quantizer's edges included, through the native
    writer and through NumPy; its header is the reference's."""
    rng = np.random.default_rng(0)
    rad = rng.random((48, 64, 3)).astype(np.float32) ** 2
    levels = (np.arange(256, dtype=np.float32) / 256.0) ** 2  # each level's lower edge
    rad[0, :, :] = np.nextafter(levels[::4], np.float32(0))[:64, None]
    rad[1, :, :] = levels[1::4][:64, None]
    rad[2, :4] = [[-1.0, 0.0, 2.0], [np.inf, 0.5, 0.25], [0.998, 0.999, 1e-30], [5, 6, 7]]
    for native in ("1", "0"):
        monkeypatch.setenv("RT_NATIVE", native)
        p, j = str(tmp_path / f"port{native}.ppm"), str(tmp_path / f"jax{native}.ppm")
        image_io.write_ppm(p, rad)
        jimage_io.write_ppm(j, rad)
        assert open(p, "rb").read() == open(j, "rb").read()
    with open(p) as f:
        assert f.read().split("\n")[:3] == ["P3", "64 48", "255"]
    np.testing.assert_array_equal(read_ppm(p), image_io._u8(rad))
    image_io.write_ppm(str(tmp_path / "t.ppm"), torch.from_numpy(rad))  # a tensor too
    assert open(str(tmp_path / "t.ppm"), "rb").read() == open(p, "rb").read()


def test_png_and_dispatch(tmp_path, monkeypatch):
    """``write_image`` picks the format by extension; PNG through PIL, and
    without PIL an ImportError that names it."""
    rad = np.random.default_rng(1).random((4, 5, 3)).astype(np.float32)
    image_io.write_image(str(tmp_path / "img.ppm"), rad)
    assert open(str(tmp_path / "img.ppm")).read(2) == "P3"
    pytest.importorskip("PIL")
    from PIL import Image

    image_io.write_image(str(tmp_path / "img.png"), rad)
    np.testing.assert_array_equal(np.asarray(Image.open(str(tmp_path / "img.png"))),
                                  image_io._u8(rad))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        image_io.write_png(str(tmp_path / "no.png"), rad)


@pytest.mark.parametrize("name", ["quads", "bouncing_spheres"])
def test_scene_stats_and_logger(tmp_path, name):
    """``scene_stats`` equals the JAX dict on the same scene (the BVH
    counts included); the logger writes JSONL records."""
    stats = scene_stats(build(name, device="cpu")[0])
    assert stats == jscene_stats(jbuild(name)[0])
    assert stats["has_bvh"] == (name == "bouncing_spheres")
    logp = str(tmp_path / "log.jsonl")
    log = JsonlLogger(logp, echo=False)
    log.log("scene_compiled", **stats)
    log.log("render_done", segments=7)
    log.close()
    with open(logp) as f:
        recs = [json.loads(line) for line in f]
    assert [r["event"] for r in recs] == ["scene_compiled", "render_done"]
    assert recs[0]["n_quads"] == stats["n_quads"] and recs[1]["segments"] == 7


def test_occupancy_histogram_matches_jax():
    """Per-bounce live fractions equal the JAX package's at 1e-6, start at
    1 and never rise."""
    kw = dict(image_width=16, samples_per_pixel=1, max_depth=6)
    occ = occupancy_histogram(build("single_sphere", device="cpu", **kw)[0],
                              build("single_sphere", device="cpu", **kw)[1])
    ref = np.asarray(jocc(*jbuild("single_sphere", **kw)))
    assert occ.shape == (6,) and float(occ[0]) == 1.0
    np.testing.assert_allclose(occ.numpy(), ref, atol=1e-6)
    assert np.all(np.diff(occ.numpy()) <= 1e-6) and float(occ[-1]) < 1.0


def test_trace_to_writes_trace(tmp_path):
    """``trace_to`` writes a Chrome trace holding the ``annotate`` spans;
    with no directory it does nothing."""
    logdir = str(tmp_path / "trace")
    with trace_to(logdir):
        with annotate("rt_probe_span"):
            torch.ones(64).cumsum(0)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "rt_probe_span" for e in events)
    with trace_to(None):
        pass


def test_checked_render_clean():
    """The wavefront render (BVH walk, texture gathers, scatter) makes no
    NaN under :func:`checked`."""
    scene, cfg = build("bouncing_spheres", device="cpu", image_width=16, samples_per_pixel=2,
                       max_depth=4)
    err, img = checked(lambda: render_once(scene, cfg, seed=3, hit_fn=closest_hit_bvh,
                                           remat=False))()
    err.throw()  # no-op when clean
    assert err.get() is None and bool(torch.isfinite(img).all())


def test_checked_catches_nan():
    err, _ = checked(lambda x: torch.sqrt(x) / torch.sum(x))(torch.tensor([-1.0, 1.0]))
    with pytest.raises(Exception, match="nan"):
        err.throw()


def test_nan_guard_raises():
    with pytest.raises(FloatingPointError):
        with nan_guard():
            torch.log(torch.zeros(4) - 1.0)
    with nan_guard(enable=False):
        torch.log(torch.zeros(4) - 1.0)


def test_nan_guard_clean_render():
    scene, cfg = build("cornell_box", device="cpu", image_width=12, samples_per_pixel=1,
                       max_depth=3)
    with nan_guard():
        img = render_once(scene, cfg, seed=1)
    assert bool(torch.isfinite(img).all())
