"""The pool's single dispatch on the CPU: ``graphs.WhileProgram`` and
``Renderer(schedule="pool", fused=True)``.

On a card a fused pool window is one launch of a CUDA graph whose WHILE
node repeats one captured ``Pool.step`` (``chip_smoke.py`` phase 33,
``tests/test_torch_cuda.py``). On the CPU the fused program runs what the
card runs around its capture (a warm-up step, then the state set again)
and the loop eagerly, so it must equal the host loop (``fused=False``)
bit for bit, and both must equal the host-count loop the pool had before
its counts moved to the device (kept here as :func:`_host_count_pool`),
iterations included.
"""
import numpy as np
import pytest
import torch

from raytracing_tpu_torch import Renderer, build
from raytracing_tpu_torch.ops import megakernel_block as mb
from raytracing_tpu_torch.ops.megakernel import build_mega_scene, pack_rays
from raytracing_tpu_torch.render import camera as cam_mod
from raytracing_tpu_torch.render import graphs
from raytracing_tpu_torch.render import pool as pool_mod
from raytracing_tpu_torch.render.camera import CameraParams

torch.set_num_threads(2)
SEED = 11


@pytest.mark.parametrize("fused", [False, True], ids=["loop", "fused"])
@pytest.mark.parametrize("k", [3, 0])
def test_while_program_runs_its_step_k_times(k, fused):
    """A toy step that counts itself and keeps the flag while the count is
    below k: a run steps exactly k times after ``init()`` (none when the
    flag starts false), a replay of the finished loop steps no more, and
    a second run does it again."""
    count = torch.zeros((), dtype=torch.int64)
    flag = torch.zeros((), dtype=torch.bool)
    calls = []

    def step():
        calls.append(int(count))
        count.add_(1)
        flag.copy_(count < k)

    def init():
        count.zero_()
        flag.fill_(k > 0)

    prog = graphs.WhileProgram(step, flag, "cpu", None, fused=fused)
    prog.run(init)
    warm_up = [0] if fused else []  # the capture's warm-up step, before init
    assert int(count) == k and calls == warm_up + list(range(k))
    prog.replay(2)
    assert int(count) == k and len(calls) == len(warm_up) + k
    prog.run(init)
    assert int(count) == k and calls == warm_up + 2 * list(range(k))
    assert prog.prepared == fused and prog.graph is None
    with pytest.raises(ValueError, match="0-d bool"):
        graphs.WhileProgram(step, count, "cpu", None)


def _host_count_pool(mega, cfg, params, seed, *, pool_size, motion_blur):
    """The pool as it ran before its counts moved to the device: a host
    loop that reads the dead and not-alive counts back every iteration and
    sizes the bank and the refill by them. Returns (radiance summed over
    the samples, segments, iterations)."""
    P, n_pix, spp = pool_size, cfg.n_pixels, cfg.samples_per_pixel
    total = n_pix * spp
    derived = cam_mod.derive(cfg, params)
    lane = torch.arange(P, dtype=torch.int32)

    def fresh(gid):
        pix = gid % n_pix
        smp = torch.div(gid, n_pix, rounding_mode="floor")
        o, d, tm = cam_mod.generate_rays(cfg, derived, pix, smp, seed, motion_blur=motion_blur)
        return pack_rays(o, d, tm, pix, smp)

    n_fill = min(P, total)
    ray_f = torch.zeros((mb.N_F, P), dtype=torch.float32)
    ray_i = torch.zeros((2, P), dtype=torch.int32)
    ray_f[:, :n_fill], ray_i[:, :n_fill] = fresh(lane[:n_fill])
    gid = torch.where(lane < total, lane, total)
    dep = torch.zeros(P, dtype=torch.int32)
    next_gid, segments, iterations = n_fill, 0, 0
    acc = torch.full((total, 3), float("nan"))
    while True:
        iterations += 1
        _, bc, state = mb.trace_block(mega, ray_f, ray_i, seed, 0,
                                      max_depth=pool_mod.K_BOUNCES, background=cfg.background,
                                      depth_cap=cfg.max_depth, dep=dep)
        segments += int(bc.sum())
        alive = state[mb.ACT] > 0.0
        key = torch.where(alive, (1 << 25) + lane,
                          torch.where(gid >= total, (1 << 24) + lane, gid))
        packed = (dep + bc) * (1 << 24) + gid
        n_dead, n_not_alive = int((key < (1 << 24)).sum()), int((key < (1 << 25)).sum())
        order = torch.argsort(key)
        ray_f, ray_i, packed = state[:, order], ray_i[:, order], packed[order]
        gid, dep = packed & ((1 << 24) - 1), packed >> 24
        acc.index_copy_(0, gid[:n_dead].long(), ray_f[mb.RR:mb.RB + 1, :n_dead].T)
        if next_gid >= total and n_not_alive == P:
            break
        n_refill = min(n_not_alive, total - next_gid)
        if n_refill:
            new = next_gid + lane[:n_refill]
            ray_f[:, :n_refill], ray_i[:, :n_refill] = fresh(new)
            gid[:n_refill] = new
            dep[:n_refill] = 0
        gid[n_refill:n_not_alive] = total
        next_gid += n_refill
    return acc.reshape(spp, n_pix, 3).sum(dim=0), segments, iterations


@pytest.mark.parametrize("name,width,spp,depth,P", [
    ("three_spheres", 32, 2, 8, 1024), ("cornell_box", 32, 3, 8, 2048),
    ("bouncing_spheres", 32, 2, 6, 1024)])
def test_pool_step_equals_the_host_count_loop(name, width, spp, depth, P):
    """``Pool.step`` (static shapes, device-scalar counts) driven by either
    program against the host-count loop: radiance bit-equal, segments and
    iterations equal, every path banked once; lanes refill (the stream is
    longer than the pool)."""
    scene, cfg = build(name, device="cpu", image_width=width, samples_per_pixel=spp,
                       max_depth=depth)
    assert cfg.n_pixels * spp > P
    mega = build_mega_scene(scene)
    params = CameraParams.from_config(cfg, "cpu")
    mblur = scene.flags.has_moving
    want, wseg, wit = _host_count_pool(mega, cfg, params, SEED, pool_size=P, motion_blur=mblur)
    assert wit > 2
    for fused in (False, True):
        prog = pool_mod.program(mega, cfg, SEED, fused=fused, pool_size=P, motion_blur=mblur)
        pool = prog.state
        prog.run(lambda: pool.init(params, 0))
        assert torch.equal(pool.radiance(), want)
        assert (int(pool.segments), int(pool.iterations)) == (wseg, wit)
        assert int(pool.banked) == cfg.n_pixels * spp and not bool(pool.flag)


def _equal(a, b):
    assert (a.segments, a.launches) == (b.segments, b.launches)
    for x, y in ((a.radiance, b.radiance), (a.u8, b.u8)):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,spp,windows", [
    ("three_spheres", 2, 1), ("cornell_box", 3, 2), ("bouncing_spheres", 3, 2)])
def test_fused_pool_render_equals_the_host_loop(monkeypatch, name, spp, windows):
    """``Renderer(schedule="pool")`` fused against ``fused=False``, f32
    and u8, with 1,024-lane pools so lanes refill; split into windows of
    two sizes (2 + 1 samples) where ``windows`` is 2, which keeps two
    programs. A second fused render reuses the programs and is the same."""
    monkeypatch.setattr(pool_mod, "POOL_SIZE", 1024)
    scene, cfg = build(name, device="cpu", image_width=32, samples_per_pixel=spp, max_depth=6)
    if windows == 2:
        monkeypatch.setattr(pool_mod, "MAX_POOL_STREAM", 2 * cfg.n_pixels + 1)
    for transfer in ("f32", "u8"):
        loop = Renderer(cfg, schedule="pool", transfer=transfer, fused=False).render(
            scene, seed=SEED)
        assert loop.launches == windows
        r = Renderer(cfg, schedule="pool", transfer=transfer)
        _equal(r.render(scene, seed=SEED), loop)
        prog = r.programs.program
        assert prog is not None and prog.prepared
        assert (r._tail_programs.program is not None) == (windows == 2)
        _equal(r.render(scene, seed=SEED), loop)
        assert r.programs.program is prog
