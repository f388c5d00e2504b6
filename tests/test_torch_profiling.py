"""The port's tracing switch on the CPU (``utils/profiling.py``): with it
off no stage records and no ``rt.`` span opens; renders, sweeps and pool
renders give the same bits with it on and off; with it on each step's
stages record a fixed number of calls a launch (chunk, iteration), the
stages do not nest, and ``trace_to``'s trace holds the render's spans;
``idle_by_span`` names idle time by the innermost span. On the CPU a
stage adds host seconds; the device clock (``csrc/stage_clock.cu``) is
held on the card (``tests/test_torch_cuda.py``)."""
import json
import os

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import Renderer, build
from raytracing_tpu_torch import bench as pbench
from raytracing_tpu_torch.utils import profiling as pf

torch.set_num_threads(2)
SEED = 5
# cornell_box, 32 px wide, depth 8: phases [2, 3, 3], launches of 1024 rays
SMALL = dict(image_width=32, samples_per_pixel=2, max_depth=8)
LAUNCH = dict(max_rays_per_launch=1024)
RENDER_STAGES = {"camera": 2, "k1": 3, "compact": 3, "accumulate": 3}
SWEEP_STAGES = {"camera": 3, "k1": 3, "compact": 4, "accumulate": 3, "loss": 1, "vjp": 2,
                "sort": 2, "k2": 1, "fold": 1}


@pytest.fixture
def switch():
    """The switch, off and zeroed again after the test whatever it did."""
    pf.reset_stages()
    try:
        yield pf
    finally:
        pf.enable(False)
        pf.reset_stages()


def _calls():
    return {k: c for k, (_, c) in pf.stage_totals("cpu")["stages"].items()}


def _sweep(spp, depth=8):
    s = pbench._fwd_bwd_setup(width=32, spp=spp, max_depth=depth, seed=7, spp_chunk=2,
                              device="cpu")
    s["plan"](fused=True)
    return s


def test_switch_off_records_no_stage_and_no_span(switch):
    scene, cfg = build("cornell_box", device="cpu", **SMALL)
    assert not pf.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        Renderer(cfg, **LAUNCH).render(scene, seed=SEED)
    assert pf.stage_totals("cpu") == dict(device="cpu", clock="perf_counter", stages={})
    assert not [e.name for e in prof.events() if e.name.startswith(pf.SPAN_PREFIX)]
    with pf.stage("k1", "cpu"), pf.stage("k1", "cpu"):  # a no-op checks nothing
        pass
    assert _calls() == {}


@pytest.mark.parametrize("what", ["render", "sweep", "pool"])
def test_results_equal_with_the_switch_on_and_off(switch, what):
    """The same bits, and the switch is part of the program's key: a
    program captured in one setting is not replayed in the other."""
    outs, keys = [], []
    scene, cfg = build("cornell_box", device="cpu", **SMALL)
    for on in (False, True, False):
        pf.enable(on)
        if what == "sweep":
            s = _sweep(4)
            outs.append([x.numpy() for x in s["sweep"](fused=True)])
            keys.append(s["programs"].key)
        else:
            r = Renderer(cfg, **LAUNCH, schedule="phased" if what == "render" else "pool")
            res = r.render(scene, seed=SEED)
            outs.append([res.radiance, np.array(res.segments)])
            keys.append(r.programs.key)
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)
    assert keys[0] != keys[1] and keys[0] == keys[2]
    assert _calls()


def test_render_stages_a_launch(switch):
    """K1's calls are launches × phases; every stage of the step records,
    and each launch records the same calls."""
    pf.enable(True)
    per_launch = []
    for spp in (2, 4):
        scene, cfg = build("cornell_box", device="cpu", **dict(SMALL, samples_per_pixel=spp))
        r = Renderer(cfg, **LAUNCH)
        pf.reset_stages()
        res = r.render(scene, seed=SEED)
        calls = _calls()
        assert calls["k1"] == res.launches * len(r.phase_depths)
        assert all(c % res.launches == 0 for c in calls.values())
        per_launch.append({k: c // res.launches for k, c in calls.items()})
    assert per_launch[0] == per_launch[1] == RENDER_STAGES
    seconds = pf.stage_totals("cpu")["stages"]
    assert all(s > 0.0 for s, _ in seconds.values())


def test_sweep_stages_a_chunk(switch):
    """K2 and the fold once a chunk; every stage of the chunk records, and
    each chunk records the same calls."""
    pf.enable(True)
    per_chunk = []
    for spp in (2, 4):
        s = _sweep(spp)
        pf.reset_stages()
        s["sweep"](fused=True)
        calls = _calls()
        n = s["n_chunks"]
        assert calls["k2"] == calls["fold"] == n
        assert all(c % n == 0 for c in calls.values())
        per_chunk.append({k: c // n for k, c in calls.items()})
    assert per_chunk[0] == per_chunk[1] == SWEEP_STAGES


def test_pool_stages_an_iteration(switch, monkeypatch):
    """Each pool iteration records k1, compact, bank and camera once; the
    window's start adds one camera call."""
    from raytracing_tpu_torch.render import pool as pool_mod

    monkeypatch.setattr(pool_mod, "POOL_SIZE", 1024)  # lanes refill
    pf.enable(True)
    scene, cfg = build("cornell_box", device="cpu", **SMALL)
    r = Renderer(cfg, schedule="pool", fused=False)
    res = r.render(scene, seed=SEED)
    assert res.launches == 1
    calls = _calls()
    iters = calls["k1"]
    assert iters > 2 and calls == {"k1": iters, "compact": iters, "bank": iters,
                                   "camera": iters + 1}


def test_stages_do_not_nest(switch):
    pf.enable(True)
    with pytest.raises(RuntimeError, match="do not nest"):
        with pf.stage("camera", "cpu"):
            with pf.stage("k1", "cpu"):
                pass
    with pytest.raises(ValueError, match="unknown stage"):
        pf.stage("shading", "cpu")
    with pf.stage("k1", "cpu"):  # the failed nest left no stage open
        pass
    assert _calls() == {"k1": 1}  # a stage left by an exception records nothing


def test_trace_to_holds_the_render_spans(switch, tmp_path):
    """``trace_to`` turns the switch on for its block: its Chrome trace
    holds the render, its replay and the copy to the host."""
    scene, cfg = build("cornell_box", device="cpu", **SMALL)
    logdir = str(tmp_path / "trace")
    with pf.trace_to(logdir):
        assert pf.enabled()
        Renderer(cfg, **LAUNCH).render(scene, seed=SEED)
    assert not pf.enabled()
    with open(os.path.join(logdir, pf.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rt.render", "rt.render.replay", "rt.render.finish", "rt.to_host"} <= names


def test_idle_by_span_names_each_stretch_by_its_innermost_span():
    """Idle [10, 20) under rt.a with rt.b nested over [12, 15), idle
    [30, 40) crossing rt.a's end at 35, idle [50, 60) under no span;
    other host ranges do not count. Microseconds in, seconds out."""
    device = [(0, 10), (20, 30), (40, 50), (60, 70)]
    host = [("rt.a", 5, 35), ("rt.b", 12, 15), ("aten::mul", 50, 60), ("rt.c", 65, 90)]
    out = pf.idle_by_span(device, host, 0, 70)
    expect = {"rt.a": 7 + 5, "rt.b": 3, pf.NO_SPAN: 5 + 10}
    assert out.keys() == expect.keys()
    for k, v in expect.items():
        assert out[k] == pytest.approx(v * 1e-6)
    assert pf.idle_by_span([(0, 70)], host, 0, 70) == {}
