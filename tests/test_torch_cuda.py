"""The port's CUDA kernels on the card: K1 (both searches, with recorded
ids, marble and image textures, and its depth cap, and the walk on a
scene too large for the sweep), K3 (its lanes refill, so no ray's result
may depend on its lane), K2, K5 (walk and dense sweep), K4 (the table
gather) and the table fold against their plain PyTorch versions (the fold
against a float64 sum), a render on the card against the same render on
the CPU, the pool schedule against the phased one, and the fused single
dispatch (renders, plans and the fwd+bwd sweep replayed as CUDA graphs,
the pool's windows as WHILE graphs) against the launch loop, and the
integrator's BVH walk (``rt_bvh_walk``) against its plain version, the
brute-force closest hit and the loop, renders and gradients, and the
stage clock (``csrc/stage_clock.cu``) in replays and WHILE loops, against
K1's launch count and CUDA events, and absent from graphs captured with
the tracing switch off. Marked
``cuda``; each test skips when no CUDA device is present. On a GPU
machine:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import contextlib
import gc

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import Renderer, build
from raytracing_tpu_torch.ops import megakernel_block as mb
from raytracing_tpu_torch.ops import megakernel_group as mg
from raytracing_tpu_torch.ops import table_gather as tg
from raytracing_tpu_torch.diff import replay_fast as rf
from raytracing_tpu_torch.diff import replay_kernel as rk
from raytracing_tpu_torch.ops.megakernel import build_mega_scene, pack_rays, trace_megakernel
from raytracing_tpu_torch.render import camera as cam
from raytracing_tpu_torch.render import pool as pool_mod
from raytracing_tpu_torch.render.camera import CameraConfig
from raytracing_tpu_torch.scene.builder import SceneBuilder
from torch_parity import (K5_EDGE_CASES, bilinear_grid, bvh_ray_sets, deep_scene,
                          deep_scene_config, k5_edge_case, noise_row, noise_row_config,
                          random_rays, random_scene, segments_close, sqrt_grads, sqrt_inputs)

pytestmark = pytest.mark.cuda
SEED = 7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cull", [False, True], ids=["sweep", "walk"])
@pytest.mark.parametrize("name,exact", [
    ("three_spheres", True), ("cornell_box", True), ("bouncing_spheres", False),
    ("perlin_sphere", False), ("earth", True)])
@pytest.mark.parametrize("b_off", [0, 3])
def test_kernel_matches_plain_version(dev, name, exact, b_off, cull):
    """K1 by either search equals its plain version bit for bit (the
    reference's bars are checked too)."""
    scene, cfg = build(name, device=dev, image_width=64, samples_per_pixel=1, max_depth=6)
    mega = build_mega_scene(scene)
    B = -(-cfg.n_pixels // 1024) * 1024
    pix = torch.clamp(torch.arange(B, device=dev), max=cfg.n_pixels - 1)
    smp = torch.zeros_like(pix)
    o, d, t = cam.generate_rays(cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, dev)),
                                pix, smp, SEED, motion_blur=scene.flags.has_moving)
    ray_f, ray_i = pack_rays(o, d, t, pix, smp)
    args = (mega, ray_f, ray_i, SEED, b_off)
    kw = dict(max_depth=6, background=cfg.background, want_ids=True)
    before = int(mb.launches)
    rad, bc, state, ids = mb.trace_block(*args, cull=cull, **kw)
    torch.cuda.synchronize()
    assert int(mb.launches) == before + 1
    rad_p, bc_p, state_p, ids_p = mb.trace_block_torch(*args, **kw)
    assert torch.equal(ids, ids_p)
    assert torch.equal(rad, rad_p) and torch.equal(bc, bc_p) and torch.equal(state, state_p)
    diff = (rad - rad_p).abs()
    assert (diff.max() < 1e-5) if exact else (diff.mean() < 2e-3)
    assert segments_close(bc_p.sum(), bc.sum())
    assert torch.isfinite(state).all()


def test_render_on_card_matches_cpu(dev):
    kw = dict(image_width=48, samples_per_pixel=2, max_depth=8)
    s_gpu, cfg = build("bouncing_spheres", device=dev, **kw)
    s_cpu, _ = build("bouncing_spheres", device="cpu", **kw)
    r = Renderer(cfg, phase_depths=[2, 2, 4])
    g = r.render(s_gpu, seed=SEED)
    c = r.render(s_cpu, seed=SEED)
    assert np.abs(g.radiance - c.radiance).mean() < 2e-3
    assert segments_close(c.segments, g.segments)


@pytest.mark.parametrize("name", ["three_spheres", "cornell_box", "bouncing_spheres"])
def test_replay_kernels_match_plain_versions(dev, name):
    """K3's radiance and counts equal its plain version's; K2's cotangents,
    reduced to the table on the CPU, match autograd through the plain
    forward at rtol 3e-5, atol 3e-6."""
    scene, cfg = build(name, device=dev, image_width=64, samples_per_pixel=1, max_depth=6)
    B = -(-cfg.n_pixels // 1024) * 1024
    pix = torch.clamp(torch.arange(B, device=dev), max=cfg.n_pixels - 1)
    smp = torch.zeros_like(pix)
    act = torch.arange(B, device=dev) < cfg.n_pixels
    o, d, t = cam.generate_rays(cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, dev)),
                                pix, smp, SEED, motion_blur=scene.flags.has_moving)
    _, _, ids, cnt = trace_megakernel(build_mega_scene(scene), o, d, t, pix, smp,
                                      cfg.background, 6, SEED, phase_depths=[2, 4], active0=act,
                                      want_ids=True, want_counts=True)
    table = rf.build_replay_table(scene).detach()
    ray_f = rk.pack_replay_rays(o, d, t, act)
    ray_i = torch.stack([pix, smp]).to(torch.int32)
    maxlen = rk.tile_maxlen(cnt, 6)
    rad_bar = torch.randn((3, B), generator=torch.Generator(dev).manual_seed(3), device=dev)
    kw = dict(seed=SEED, n_sph=scene.n_spheres, has_moving=scene.flags.has_moving,
              background=cfg.background)
    rad, bc = rk.replay_fwd(table, ids, ray_f, ray_i, maxlen, **kw)
    g = rk.replay_bwd(table, ids, ray_f, ray_i, rad_bar, maxlen, **kw)
    torch.cuda.synchronize()
    rad_p, bc_p = rk.replay_fwd_torch(table, ids, ray_f, ray_i, maxlen, **kw)
    g_p = rk.replay_bwd_torch(table, ids, ray_f, ray_i, rad_bar, maxlen, **kw)
    assert torch.equal(rad, rad_p) and torch.equal(bc, bc_p)
    L = table.shape[0]
    torch.testing.assert_close(rk.reduce_table_grads(g.cpu(), ids.cpu(), L),
                               rk.reduce_table_grads(g_p.cpu(), ids.cpu(), L),
                               rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("name,depth,phases,past", [
    ("cornell_box", 40, [8, 32], 32), ("deep", 72, [8, 64], 64), ("deep", 96, [8, 88], 64)])
def test_replay_kernels_deeper_than_32_bounces(dev, name, depth, phases, past):
    """Replays past the 32 and 64 bounces K2's stash once held: cornell_box
    at depth 40, whose closed room keeps rays bouncing past 32, and the
    deep scene (the camera inside a fuzz-0 metal sphere) at depths 72 and
    96, past 64; K3 and K2 against their plain versions at the bars above,
    and the fold of K2's bounces, one launch per window of 64 bounces,
    against the plain reduction (the deep scene's against its float64
    sum, at the fold's bar)."""
    if name == "deep":
        scene = deep_scene(SceneBuilder()).compile(dev)
        cfg = deep_scene_config(CameraConfig, image_width=64, max_depth=depth)
    else:
        scene, cfg = build(name, device=dev, image_width=64, samples_per_pixel=1,
                           max_depth=depth)
    B = -(-cfg.n_pixels // 1024) * 1024
    pix = torch.clamp(torch.arange(B, device=dev), max=cfg.n_pixels - 1)
    smp = torch.zeros_like(pix)
    act = torch.arange(B, device=dev) < cfg.n_pixels
    o, d, t = cam.generate_rays(cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, dev)),
                                pix, smp, SEED, motion_blur=scene.flags.has_moving)
    _, _, ids, cnt = trace_megakernel(build_mega_scene(scene), o, d, t, pix, smp,
                                      cfg.background, depth, SEED, phase_depths=phases,
                                      active0=act, want_ids=True, want_counts=True)
    assert int((cnt > past).sum()) > 0
    table = rf.build_replay_table(scene).detach()
    ray_f = rk.pack_replay_rays(o, d, t, act)
    ray_i = torch.stack([pix, smp]).to(torch.int32)
    maxlen = rk.tile_maxlen(cnt, depth)
    rad_bar = torch.randn((3, B), generator=torch.Generator(dev).manual_seed(3), device=dev)
    kw = dict(seed=SEED, n_sph=scene.n_spheres, has_moving=scene.flags.has_moving,
              background=cfg.background)
    rad, bc = rk.replay_fwd(table, ids, ray_f, ray_i, maxlen, **kw)
    g = rk.replay_bwd(table, ids, ray_f, ray_i, rad_bar, maxlen, **kw)
    torch.cuda.synchronize()
    rad_p, bc_p = rk.replay_fwd_torch(table, ids, ray_f, ray_i, maxlen, **kw)
    g_p = rk.replay_bwd_torch(table, ids, ray_f, ray_i, rad_bar, maxlen, **kw)
    assert torch.equal(rad, rad_p) and torch.equal(bc, bc_p)
    L = table.shape[0]
    tb_p = rk.reduce_table_grads(g_p.cpu(), ids.cpu(), L)
    torch.testing.assert_close(rk.reduce_table_grads(g.cpu(), ids.cpu(), L), tb_p,
                               rtol=3e-5, atol=3e-6)
    before = int(tg.fold_launches)
    tb_k = rk.reduce_table_grads(g, ids, L).cpu()
    assert int(tg.fold_launches) == before + -(-depth // tg.FOLD_MAX_D)
    if name == "deep":
        # every bounce of every ray adds to the mirror's row, in an order the
        # fold's atomics change from run to run: the fold's own bar
        # (chip_smoke.py phase 11) against the float64 sum, atol 2e-6 per
        # ray-bounce that row takes
        exact = tg.fold_torch(g_p.cpu().double(), ids.cpu(), L)[:, rk._GSLOTS]
        hits = ids[ids >= 0].long().cpu()
        atol = 2e-6 * torch.bincount(hits, minlength=L).clamp(min=1).double()[:, None]
        err = (tb_k[:, rk._TCOLS].double() - exact).abs()
        assert bool((err <= atol + 1e-5 * exact.abs()).all()), float((err - atol).max())
    else:
        torch.testing.assert_close(tb_k, tb_p, rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("name", ["cornell_box", "bouncing_spheres", "simple_light", "earth"])
def test_group_kernel_matches_plain_version(dev, name):
    """K5 through the BVH walk and through the dense sweep: every output
    bit-equal to the plain version, and the walk equal to the sweep."""
    scene, cfg = build(name, device=dev, image_width=64, samples_per_pixel=1, max_depth=6)
    mega = build_mega_scene(scene)
    B = -(-cfg.n_pixels // 1024) * 1024
    pix = torch.clamp(torch.arange(B, device=dev), max=cfg.n_pixels - 1)
    smp = torch.zeros_like(pix)
    o, d, t = cam.generate_rays(cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, dev)),
                                pix, smp, SEED, motion_blur=scene.flags.has_moving)
    ray_f, ray_i = pack_rays(o, d, t, pix, smp, torch.arange(B, device=dev) < cfg.n_pixels)
    outs = []
    for use_bvh in (True, False):
        kw = dict(max_depth=6, background=cfg.background, use_bvh=use_bvh)
        before = int(mg.launches)
        out = mg.trace_group(mega, ray_f, ray_i, SEED, 3, **kw)
        torch.cuda.synchronize()
        assert int(mg.launches) == before + 1
        ref = mg.trace_group_torch(mega, ray_f, ray_i, SEED, 3, **kw)
        for x, y in zip(out, ref):
            assert torch.equal(x, y)
        outs.append(out)
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    assert int(outs[0][1].sum()) > 0


@pytest.mark.parametrize("case", K5_EDGE_CASES)
def test_group_kernel_edge_cases_match_plain_version(dev, case):
    """K5 at the edges of its member test (a discriminant of exactly 0,
    negative ones, leaves with pad slots, equal roots in two leaves), walk
    and sweep: every output bit-equal to the plain version; so is K5's
    probe in both designs, timed and counting, and the counting
    instantiation counts the plain version's box and member tests."""
    mega, ray_f, ray_i = k5_edge_case(case, dev)
    for use_bvh in (True, False):
        kw = dict(max_depth=3, background=(0.7, 0.8, 1.0), use_bvh=use_bvh)
        before = int(mg.launches)
        out = mg.trace_group(mega, ray_f, ray_i, SEED, 0, **kw)
        torch.cuda.synchronize()
        assert int(mg.launches) == before + 1
        ref = mg.trace_group_torch(mega, ray_f, ray_i, SEED, 0, want_counts=True, **kw)
        for x, y in zip(out, ref[:3]):
            assert torch.equal(x, y)
        if not use_bvh:
            continue
        for design in mg.DESIGNS:
            for count in (False, True):
                *probe, c = mg.trace_group_probe(mega, ray_f, ray_i, SEED, 0, design=design,
                                                 count=count, max_depth=3,
                                                 background=(0.7, 0.8, 1.0))
                for x, y in zip(probe, ref[:3]):
                    assert torch.equal(x, y)
        assert (c["visits"], c["sphere_tests"], c["quad_tests"]) == tuple(
            int(v) for v in ref[3].sum(1))
        assert 0 < c["box_lanes"] <= 32 * c["box_issues"]


def test_sqrt_rn_on_the_card_is_the_float64_route(dev):
    """sqrt_rn on CUDA tensors, and the card's float32 sqrt, equal the
    float64 route (correctly rounded) bit for bit on 2^24 random float32
    inputs (every exponent, denormals included), 0, the largest float and
    every power of two; so does sqrt_rn's gradient, on the card and
    against the CPU's."""
    from raytracing_tpu_torch.ops.intersect import sqrt_rn

    xs = sqrt_inputs(dev)
    ref = torch.sqrt(xs.double()).float()
    assert int((torch.sqrt(xs) != ref).sum()) == 0
    assert int((sqrt_rn(xs) != ref).sum()) == 0
    assert torch.equal(sqrt_rn(xs).cpu(), sqrt_rn(xs.cpu()))
    g = torch.randn(xs.shape, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    ref_g = sqrt_grads(lambda x: torch.sqrt(x.double()).float(), xs, g)
    assert torch.equal(sqrt_grads(sqrt_rn, xs, g), ref_g)
    assert torch.equal(sqrt_grads(sqrt_rn, xs.cpu(), g.cpu()), ref_g.cpu())


@pytest.mark.parametrize("L,F,B", [(512, 23, 360_448), (4224, 23, 4096), (128, 5, 1000),
                                   (512, 23, 4099), (4224, 23, 360_448)])
def test_table_gather_matches_plain_version(dev, L, F, B):
    """K4: bit-equal to ``index_select`` on clipped ids (out-of-range and
    -1 ids included), at B not a multiple of 4 and at L = 4,224 too; its
    backward (the fold kernel on the card, ``index_add_`` on the CPU)
    equal to the CPU's to float32 reassociation: each row sums ~B/L
    unit-normal cotangents in atomic order (measured 6.1e-5 at
    B/L = 704)."""
    rng = np.random.default_rng(L)
    table = torch.from_numpy(rng.normal(size=(L, F)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(-2, L + 3, B).astype(np.int32)).to(dev)
    before = int(tg.launches)
    out = tg.gather(table, ids)
    torch.cuda.synchronize()
    assert int(tg.launches) == before + 1 and out.shape == (F, B) and out.is_contiguous()
    assert torch.equal(out, tg.gather_torch(table, ids))
    tb = table.clone().requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(F, B)).astype(np.float32))
    (tg.table_lookup(tb, ids) * w.to(dev)).sum().backward()
    tc = table.cpu().requires_grad_(True)
    (tg.table_lookup(tc, ids.cpu()) * w).sum().backward()
    torch.testing.assert_close(tb.grad.cpu(), tc.grad, rtol=1e-5, atol=2e-6 * max(1, B // L))


@pytest.mark.parametrize("L", [512, 4224])
@pytest.mark.parametrize("miss", [0.3, 0.9])
def test_fold_matches_float64_sum(dev, L, miss):
    """The fold kernel, one bounce (the lookup's backward) and batched over
    bounces with prefixes (the replay's reduction), against a float64 sum
    at rtol 1e-5, atol 2e-6·max(1, k) for k the most rays one row takes
    (B/L for uniform ids, as in test_table_gather_matches_plain_version);
    ids with a share ``miss`` of -1 (row 0 then takes most adds),
    out-of-range ids, and exact zeros."""
    F, B = 23, 360_448
    rng = np.random.default_rng(L + int(10 * miss))
    ids = rng.integers(0, L + 3, (3, B)).astype(np.int32)
    ids[rng.random((3, B)) < miss] = -1
    g = rng.normal(size=(3, F, B)).astype(np.float32)
    g[:, :, rng.random(B) < 0.2] = 0.0
    g, ids = torch.from_numpy(g).to(dev), torch.from_numpy(ids).to(dev)
    for prefixes in (None, (B, 100_001, 0)):
        for gg, ii in ((g[0], ids[0]), (g, ids)):
            rows = torch.bincount(ii.reshape(-1).clamp(0, L - 1).long(), minlength=L)
            bar = dict(rtol=1e-5, atol=2e-6 * max(1, int(rows.max())))
            before = int(tg.fold_launches)
            out = tg.fold(gg, ii, L, None if gg.dim() == 2 else prefixes)
            torch.cuda.synchronize()
            assert int(tg.fold_launches) == before + 1 and out.shape == (L, F)
            exact = tg.fold_torch(gg.double()[None] if gg.dim() == 2 else gg.double(),
                                  ii[None] if ii.dim() == 1 else ii, L,
                                  None if gg.dim() == 2 else prefixes)
            torch.testing.assert_close(out.double(), exact, **bar)


def test_k3_rays_do_not_depend_on_their_lane(dev):
    """K3, whose lanes refill, on a chunk and on the same chunk with its
    rays permuted: every ray's radiance and bounce count bit-equal, and
    bit-equal to the plain version; K3's probe in both designs gives the
    same outputs and counts the plain version's segments; K2's cotangents
    permute with the rays too."""
    scene, cfg = build("bouncing_spheres", device=dev, image_width=64, samples_per_pixel=2,
                       max_depth=8)
    B = -(-cfg.n_pixels // 1024) * 1024 * 2
    pix = torch.clamp(torch.arange(B, device=dev) % (B // 2), max=cfg.n_pixels - 1)
    smp = torch.arange(B, device=dev) // (B // 2)
    act = (torch.arange(B, device=dev) % (B // 2)) < cfg.n_pixels
    o, d, t = cam.generate_rays(cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, dev)),
                                pix, smp, SEED, motion_blur=scene.flags.has_moving)
    _, _, ids = trace_megakernel(build_mega_scene(scene), o, d, t, pix, smp, cfg.background, 8,
                                 SEED, phase_depths=[2, 6], active0=act, want_ids=True)
    table = rf.build_replay_table(scene).detach()
    ray_f = rk.pack_replay_rays(o, d, t, act)
    ray_i = torch.stack([pix, smp]).to(torch.int32)
    maxlen = torch.full((B // 1024,), 8, dtype=torch.int32, device=dev)
    rad_bar = torch.randn((3, B), generator=torch.Generator(dev).manual_seed(3), device=dev)
    kw = dict(seed=SEED, n_sph=scene.n_spheres, has_moving=scene.flags.has_moving,
              background=cfg.background)
    before = int(rk.fwd_launches)
    rad, bc = rk.replay_fwd(table, ids, ray_f, ray_i, maxlen, **kw)
    torch.cuda.synchronize()
    assert int(rk.fwd_launches) == before + 1
    rad_p, bc_p = rk.replay_fwd_torch(table, ids, ray_f, ray_i, maxlen, **kw)
    assert torch.equal(rad, rad_p) and torch.equal(bc, bc_p)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(B)).to(dev)
    args_p = (table, ids[:, perm].contiguous(), ray_f[:, perm].contiguous(),
              ray_i[:, perm].contiguous(), maxlen)
    rad_q, bc_q = rk.replay_fwd(*args_p, **kw)
    assert torch.equal(rad_q, rad[:, perm]) and torch.equal(bc_q, bc[perm])
    for design in rk.K3_DESIGNS:
        r1, b1, _ = rk.replay_fwd_probe(table, ids, ray_f, ray_i, maxlen, design=design, **kw)
        r2, b2, c = rk.replay_fwd_probe(table, ids, ray_f, ray_i, maxlen, design=design,
                                        count=True, **kw)
        assert all(torch.equal(x, y) for x, y in ((r1, rad), (r2, rad), (b1, bc), (b2, bc)))
        assert c["bounces"] == int(bc.sum()) and 0 < c["bounces"] <= 32 * c["issues"]
    assert int(rk.fwd_launches) == before + 2
    g = rk.replay_bwd(table, ids, ray_f, ray_i, rad_bar, maxlen, **kw)
    g_q = rk.replay_bwd(*args_p[:4], rad_bar[:, perm].contiguous(), maxlen, **kw)
    assert torch.equal(g_q, g[:, :, perm])


def test_depth_cap_matches_plain_version(dev):
    """K1's depth-cap mode on pool-shaped rays (each with its own depth):
    bit-equal to the plain version, no ray past the cap."""
    scene, cfg = build("perlin_sphere", device=dev, image_width=64, samples_per_pixel=1,
                       max_depth=8)
    mega = build_mega_scene(scene)
    B = -(-cfg.n_pixels // 1024) * 1024
    pix = torch.clamp(torch.arange(B, device=dev), max=cfg.n_pixels - 1)
    smp = torch.zeros_like(pix)
    o, d, t = cam.generate_rays(cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, dev)),
                                pix, smp, SEED, motion_blur=scene.flags.has_moving)
    ray_f, ray_i = pack_rays(o, d, t, pix, smp)
    dep = torch.from_numpy(np.random.default_rng(1).integers(0, 8, B).astype(np.int32)).to(dev)
    kw = dict(max_depth=3, background=cfg.background, depth_cap=8, dep=dep)
    out = mb.trace_block(mega, ray_f, ray_i, SEED, 0, **kw)
    torch.cuda.synchronize()
    ref = mb.trace_block_torch(mega, ray_f, ray_i, SEED, 0, **kw)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    assert bool((dep + out[1] <= 8).all())


def test_pool_render_matches_phased(dev, monkeypatch):
    """Renderer(schedule="pool") on the card, its pool smaller than the
    stream so lanes are refilled: the phased render's segments exactly
    and its image to float32 reassociation of the per-pixel sums."""
    scene, cfg = build("bouncing_spheres", device=dev, image_width=64, samples_per_pixel=4,
                       max_depth=8)
    monkeypatch.setattr(pool_mod, "POOL_SIZE", 4096)
    before = int(mb.launches)
    pool = Renderer(cfg, schedule="pool").render(scene, seed=SEED)
    assert int(mb.launches) > before
    phased = Renderer(cfg).render(scene, seed=SEED)
    assert pool.segments == phased.segments
    np.testing.assert_allclose(pool.radiance, phased.radiance, rtol=2e-6, atol=2e-6)



@pytest.mark.parametrize("k", [5, 0])
def test_while_graph_counts_its_iterations(dev, k):
    """A toy WHILE program: its step adds one to a device counter and sets
    the flag while the counter is below k. One launch of the WHILE graph
    runs it k times (none when the flag starts false) with no host read,
    a launch on the finished state runs none, and a second run reuses the
    capture."""
    from raytracing_tpu_torch.render import graphs

    count = torch.zeros((), dtype=torch.int64, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)

    def step():
        count.add_(1)
        flag.copy_(count < k)

    def init():
        count.zero_()
        flag.fill_(k > 0)

    prog = graphs.WhileProgram(step, flag, dev, None)
    assert prog.run(init) > 0.0 and prog.graph is not None
    assert int(count) == k
    prog.replay(1)
    assert int(count) == k
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert prog.run(init) == 0.0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(count) == k and not bool(flag)


def test_fused_pool_equals_the_looped_pool(dev, monkeypatch):
    """Renderer(schedule="pool") fused (each window one launch of its
    WHILE graph) against fused=False (the host loop), a 4,096-lane pool
    so lanes refill: f32 and u8 images, segments and K1 launches equal,
    in one window and split into windows of two sizes (two programs)."""
    scene, cfg = build("bouncing_spheres", device=dev, image_width=64, samples_per_pixel=4,
                       max_depth=8)
    monkeypatch.setattr(pool_mod, "POOL_SIZE", 4096)
    for split in (False, True):
        if split:  # windows of 3 and 1 samples
            monkeypatch.setattr(pool_mod, "MAX_POOL_STREAM", cfg.n_pixels * 3 + 1)
        for transfer in ("f32", "u8"):
            fused = Renderer(cfg, schedule="pool", transfer=transfer)
            fused.render(scene, seed=SEED)  # captures
            assert fused.programs.program.graph is not None
            assert (fused._tail_programs.program is not None) == split
            runs = []
            for r in (fused, Renderer(cfg, schedule="pool", transfer=transfer, fused=False)):
                before = int(mb.launches)
                runs.append((r.render(scene, seed=SEED), int(mb.launches) - before))
            (a, na), (b, nb) = runs
            assert na == nb > 0 and a.segments == b.segments and a.launches == b.launches
            for x, y in ((a.radiance, b.radiance), (a.u8, b.u8)):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)

def test_walk_runs_a_scene_beyond_the_sweeps_shared_memory(dev):
    """9,001 spheres: the sweep's tables exceed a block's shared memory, so
    the sweep refuses the scene and the walk, chosen by default, traces it
    equal to the plain version bit for bit."""
    from raytracing_tpu_torch.render.camera import CameraConfig
    from raytracing_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian((0.5, 0.5, 0.5)))
    rng = np.random.default_rng(9)
    mats = [b.lambertian(tuple(rng.random(3))) for _ in range(8)] + [b.dielectric(1.5)]
    for k in range(9000):
        b.sphere((rng.uniform(-48, 48), 0.2, rng.uniform(-48, 48)), 0.2, mats[k % len(mats)])
    scene = b.compile(dev)
    cfg = CameraConfig(aspect_ratio=16.0 / 9.0, image_width=48, samples_per_pixel=1,
                       max_depth=5, background=(0.7, 0.8, 1.0), vfov=20.0,
                       lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0))
    mega = build_mega_scene(scene)
    B = -(-cfg.n_pixels // 1024) * 1024
    pix = torch.clamp(torch.arange(B, device=dev), max=cfg.n_pixels - 1)
    smp = torch.zeros_like(pix)
    o, d, t = cam.generate_rays(cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, dev)),
                                pix, smp, SEED, motion_blur=False)
    ray_f, ray_i = pack_rays(o, d, t, pix, smp)
    kw = dict(max_depth=5, background=cfg.background, want_ids=True)
    assert mb.walks(mega)
    with pytest.raises(ValueError, match="shared memory"):
        mb.trace_block(mega, ray_f, ray_i, SEED, 0, cull=False, **kw)
    out = mb.trace_block(mega, ray_f, ray_i, SEED, 0, **kw)
    ref = mb.trace_block_torch(mega, ray_f, ray_i, SEED, 0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert int(out[1].sum()) > B


@pytest.mark.parametrize("name,method", [("three_spheres", "mega"), ("cornell_box", "mega"),
                                         ("bouncing_spheres", "mega"),
                                         ("three_spheres", "brute")])
def test_fused_render_equals_the_loop(dev, name, method):
    """``Renderer(fused=True)`` replays a captured CUDA graph once a
    launch: its image, segments, ``ok`` and kernel launches equal the
    launch loop's bit for bit, with and without planned prefixes."""
    scene, cfg = build(name, device=dev, image_width=64, samples_per_pixel=4, max_depth=6)
    kw = dict(hit_method=method, max_rays_per_launch=2048, phase_depths=[1, 2, 3])
    pref = None
    if method == "mega":
        pref = Renderer(cfg, **kw, fused=False).plan_phase_prefixes(scene, seed=SEED)
        assert Renderer(cfg, **kw).plan_phase_prefixes(scene, seed=SEED) == pref
    for p in {None, pref}:
        fused = Renderer(cfg, **kw, phase_prefixes=p)
        fused.render(scene, seed=SEED)  # captures
        assert fused.programs.program.graph is not None
        before = int(mb.launches)
        a = fused.render(scene, seed=SEED)
        n_fused = int(mb.launches) - before
        before = int(mb.launches)
        b = Renderer(cfg, **kw, phase_prefixes=p, fused=False).render(scene, seed=SEED)
        assert n_fused == int(mb.launches) - before
        assert (a.segments, a.ok, a.launches) == (b.segments, b.ok, b.launches)
        np.testing.assert_array_equal(a.radiance, b.radiance)
    # resumed from every sample chunk's state, the last (nothing left to
    # replay) included: the whole render, bit for bit
    whole = Renderer(cfg, **kw, phase_prefixes=pref).render(scene, seed=SEED)
    states = []
    Renderer(cfg, **kw, phase_prefixes=pref).render(scene, seed=SEED,
                                                    checkpoint_cb=states.append)
    assert len(states) >= 2
    for k, state in enumerate(states, 1):
        res = Renderer(cfg, **kw, phase_prefixes=pref).render(scene, seed=SEED,
                                                              resume_state=state)
        assert res.launches == whole.launches * (len(states) - k) // len(states)
        assert res.segments == whole.segments
        np.testing.assert_array_equal(res.radiance, whole.radiance)


def test_capture_holds_off_the_cycle_collector(dev):
    """A program captures with Python's cycle collector off (a dead
    program freed mid-capture would destroy its graph and invalidate the
    capture), turns it back on, and replays its steps in order."""
    from raytracing_tpu_torch.render import graphs

    seen = []

    def step(counter, st):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        st["x"].add_(counter)

    st, _ = graphs.over_chunks(
        graphs.ProgramSlot(), "k", lambda: dict(x=torch.zeros((), dtype=torch.int64, device=dev)),
        step, 2, 4, dev, True)
    assert seen == [False] and gc.isenabled() and int(st["x"]) == 2 + 3 + 4 + 5


def test_fused_sweep_equals_the_loop(dev):
    """``bench``'s fwd+bwd sweep as one replayed chunk program: loss,
    segments and ``ok`` equal the chunk loop's, the gradients within
    float32 reassociation (the fold's atomics), the launches equal."""
    from raytracing_tpu_torch import bench as pbench

    s = pbench._fwd_bwd_setup(width=64, spp=8, max_depth=8, spp_chunk=2, device=dev)
    assert s["plan"](fused=True) == s["plan"](fused=False)
    s["sweep"](fused=True)  # captures
    counts = []
    outs = []
    for fused in (True, False):
        before = (int(mb.launches), int(rk.bwd_launches), int(tg.fold_launches))
        outs.append(s["sweep"](fused=fused))
        torch.cuda.synchronize()
        counts.append(tuple(x - y for x, y in zip(
            (int(mb.launches), int(rk.bwd_launches), int(tg.fold_launches)), before)))
    (lf, gcf, grf, sf, okf), (ll, gcl, grl, sl, okl) = outs
    assert counts[0] == counts[1] and counts[0][1] == s["n_chunks"]
    assert bool(okf) and bool(okl) and int(sf) == int(sl) > 0
    assert float(lf) == float(ll)
    for a, b in ((gcf, gcl), (grf, grl)):
        assert float((a - b).double().norm()) <= 1e-5 * max(float(b.double().norm()), 1e-30)


@pytest.mark.parametrize("case", ["camera", "bounce 1", "random", "moving"])
def test_bvh_walk_matches_plain_and_brute(dev, case):
    """``rt_bvh_walk`` against the plain walk (winner and ``t`` bit for
    bit, one launch a call) and ``closest_hit_bvh`` against the
    brute-force closest hit (validity equal, ``t`` bit-equal where the
    primitive is the same, ties at most B/1000)."""
    from raytracing_tpu_torch.ops import traverse
    from raytracing_tpu_torch.ops.intersect import BIG, T_MIN, closest_hit_brute

    if case in ("camera", "bounce 1"):
        scene, cfg = build("bouncing_spheres", device=dev, image_width=160,
                           samples_per_pixel=2, max_depth=4)
        o, d, t = bvh_ray_sets(scene, cfg, SEED)[case]
    else:
        seed = 7 if case == "moving" else 0
        scene = random_scene(SceneBuilder(), seed, moving=case == "moving").compile(device=dev)
        o, d, t = (torch.from_numpy(x).to(dev) for x in random_rays(100 + seed, 4096))
    before = int(traverse.launches)
    prim, tb = traverse.walk(scene, o, d, t)
    assert int(traverse.launches) == before + 1
    ref_prim, ref_t = traverse._traverse(scene, o, d, t, T_MIN, BIG)
    assert torch.equal(prim, ref_prim) and torch.equal(tb, ref_t)
    hv = traverse.closest_hit_bvh(scene, o, d, t)
    hb = closest_hit_brute(scene, o, d, t)
    same = hv.prim_id == hb.prim_id
    assert torch.equal(hv.valid, hb.valid) and torch.equal(hv.t[same], hb.t[same])
    assert int((~same).sum()) <= o.shape[0] // 1000
    assert int(hv.valid.sum()) > o.shape[0] // 20


def test_fused_bvh_render_equals_the_loop(dev):
    """``Renderer(hit_method="bvh")`` replays its captured launch with the
    walk kernel inside, with no host read until the image comes back
    (``set_sync_debug_mode("error")``), bit-equal to the loop, one walk
    launch a bounce of every launch; ``"auto"`` takes the same path on an
    inexpressible scene of more than 64 primitives."""
    import sys
    from pathlib import Path

    from raytracing_tpu_torch.ops import traverse

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from time_fused import no_host_reads

    scene, cfg = build("bouncing_spheres", device=dev, image_width=64, samples_per_pixel=4,
                       max_depth=6)
    kw = dict(max_rays_per_launch=2048)
    fused = Renderer(cfg, hit_method="bvh", **kw)
    fused.render(scene, seed=SEED)  # captures
    assert fused.programs.program.graph is not None
    traverse.launches.reset()
    with no_host_reads(fused, "render"):
        a = fused.render(scene, seed=SEED)
    assert int(traverse.launches) == cfg.max_depth * a.launches
    traverse.launches.reset()
    b = Renderer(cfg, hit_method="bvh", fused=False, **kw).render(scene, seed=SEED)
    assert int(traverse.launches) == cfg.max_depth * b.launches
    assert (a.segments, a.launches) == (b.segments, b.launches)
    np.testing.assert_array_equal(a.radiance, b.radiance)
    c = Renderer(cfg, hit_method="brute", **kw).render(scene, seed=SEED)
    assert np.abs(a.radiance - c.radiance).mean() < 2e-3
    assert segments_close(c.segments, a.segments)

    cfg2 = CameraConfig(aspect_ratio=1.0, image_width=48, samples_per_pixel=2, max_depth=3,
                        vfov=30.0, lookfrom=(0.0, 1.5, 6.0), lookat=(0.0, 0.3, 0.0),
                        background=(0.7, 0.8, 1.0))
    s2 = bilinear_grid(SceneBuilder()).compile(device=dev, image_bilinear=True)
    auto = Renderer(cfg2, **kw)
    assert auto.resolve_hit_method(s2) == "bvh"
    x = auto.render(s2, seed=SEED)
    assert auto.programs.program.graph is not None
    y = Renderer(cfg2, fused=False, **kw).render(s2, seed=SEED)
    assert x.segments == y.segments
    np.testing.assert_array_equal(x.radiance, y.radiance)


def test_bvh_render_once_and_grads_equal_brute(dev):
    """``render_once`` and ``scene_grad`` through ``closest_hit_bvh`` (the
    kernel) equal those through the brute-force hit, as
    tests/test_torch_traverse.py holds them on the CPU."""
    from raytracing_tpu_torch.diff.gradients import render_once, scene_grad
    from raytracing_tpu_torch.ops import traverse
    from raytracing_tpu_torch.ops.intersect import closest_hit_brute

    scene = noise_row(SceneBuilder()).compile(device=dev)
    cfg = noise_row_config(CameraConfig)
    before = int(traverse.launches)
    img_bvh = render_once(scene, cfg, seed=4, hit_fn=traverse.closest_hit_bvh)
    assert int(traverse.launches) == before + cfg.max_depth
    img_brute = render_once(scene, cfg, seed=4, hit_fn=closest_hit_brute)
    assert torch.equal(img_bvh, img_brute)
    target = torch.full((cfg.image_height, cfg.image_width, 3), 0.3, device=dev)
    g_bvh = scene_grad(scene, target, cfg, seed=4, hit_fn=traverse.closest_hit_bvh)
    g_brute = scene_grad(scene, target, cfg, seed=4, hit_fn=closest_hit_brute)
    for group, field in (("spheres", "center"), ("spheres", "radius"), ("textures", "rgb"),
                         ("quads", "q"), ("materials", "fuzz")):
        a = getattr(getattr(g_bvh, group), field)
        r = getattr(getattr(g_brute, group), field)
        np.testing.assert_allclose(a.cpu().numpy(), r.cpu().numpy(), rtol=1e-5, atol=1e-9,
                                   err_msg=f"{group}.{field}")
    assert float(g_brute.spheres.center.abs().sum()) > 0


@pytest.fixture
def tracing():
    """The port's tracing switch on (``utils.profiling``), off again and
    the stage clock zeroed after the test."""
    from raytracing_tpu_torch.utils import profiling as pf

    pf.enable(True)
    pf.reset_stages()
    try:
        yield pf
    finally:
        pf.enable(False)
        pf.reset_stages()


@pytest.mark.parametrize("schedule", ["phased", "pool"])
def test_stage_clock_counts_k1_in_replays_and_while_loops(dev, tracing, monkeypatch, schedule):
    """The ``k1`` stage's calls in a replayed launch program (phased) and
    in a WHILE graph (the pool, where the profiler sees no kernel) equal
    K1's launch count; every stage of the step records device time."""
    pf = tracing
    monkeypatch.setattr(pool_mod, "POOL_SIZE", 4096)  # the pool's lanes refill
    scene, cfg = build("bouncing_spheres", device=dev, image_width=64, samples_per_pixel=4,
                       max_depth=8)
    r = Renderer(cfg, schedule=schedule)
    r.render(scene, seed=SEED)  # captures
    pf.reset_stages()
    before = int(mb.launches)
    r.render(scene, seed=SEED)
    totals = pf.stage_totals(dev)
    assert totals["clock"] == "globaltimer"
    assert totals["device"] == torch.cuda.get_device_name(dev)
    stages = totals["stages"]
    expect = ({"camera", "k1", "compact", "accumulate"} if schedule == "phased"
              else {"camera", "k1", "compact", "bank"})
    assert set(stages) == expect
    assert stages["k1"][1] == int(mb.launches) - before > 0
    assert all(s > 0.0 for s, _ in stages.values())


def test_k1_stage_time_matches_cuda_events(dev, tracing):
    """The ``k1`` stage's device seconds over 20 bench-sized K1 launches,
    queued behind a spin kernel so the host adds no gap, within 6% of CUDA
    events recorded around the same launches inside the stage."""
    pf = tracing
    scene, cfg = build("bouncing_spheres", device=dev, image_width=400, samples_per_pixel=1,
                       max_depth=20)
    mega = build_mega_scene(scene)
    B = -(-cfg.n_pixels // 1024) * 1024
    pix = torch.clamp(torch.arange(B, device=dev), max=cfg.n_pixels - 1)
    smp = torch.zeros_like(pix)
    o, d, t = cam.generate_rays(cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, dev)),
                                pix, smp, SEED, motion_blur=scene.flags.has_moving)
    ray_f, ray_i = pack_rays(o, d, t, pix, smp)
    kw = dict(max_depth=20, background=cfg.background)
    mb.trace_block(mega, ray_f, ray_i, SEED, 0, **kw)  # warm-up
    with pf.stage("k1", dev):
        pass
    torch.cuda.synchronize()
    pf.reset_stages()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(20)]
    torch.cuda._sleep(100_000_000)
    for e0, e1 in events:
        with pf.stage("k1", dev):
            e0.record()
            mb.trace_block(mega, ray_f, ray_i, SEED, 0, **kw)
            e1.record()
    torch.cuda.synchronize()
    seconds, calls = pf.stage_totals(dev)["stages"]["k1"]
    event_s = sum(e0.elapsed_time(e1) for e0, e1 in events) * 1e-3
    assert calls == 20
    assert abs(seconds - event_s) <= 0.06 * event_s, (seconds, event_s)


def _graph_nodes(graph):
    """(kernel nodes, rt_stage_mark nodes) of a captured graph."""
    import ctypes

    from raytracing_tpu_torch import _kernels

    lib = _kernels.library().lib
    n_k, n_m = ctypes.c_int(), ctypes.c_int()
    err = lib.rt_graph_kernel_nodes(graph.raw_cuda_graph(), ctypes.byref(n_k), ctypes.byref(n_m))
    assert err == 0, lib.rt_error_string(err).decode()
    return n_k.value, n_m.value


@pytest.mark.parametrize("what", ["trace", "pool"])
def test_a_graph_captured_with_the_switch_off_has_no_mark(dev, monkeypatch, what):
    """A phased trace and a pool iteration captured (``keep_graph``) three
    ways: with the stage calls taken out of the code, with the switch off
    and with it on. Off holds the very kernel nodes of the code without
    stages and no mark; on holds two marks more a stage call."""
    from raytracing_tpu_torch.ops import megakernel as mk
    from raytracing_tpu_torch.render import graphs
    from raytracing_tpu_torch.utils import profiling as pf

    scene, cfg = build("bouncing_spheres", device=dev, image_width=64, samples_per_pixel=1,
                       max_depth=8)
    mega = build_mega_scene(scene)
    B = -(-cfg.n_pixels // 1024) * 1024
    pix = torch.clamp(torch.arange(B, device=dev), max=cfg.n_pixels - 1)
    smp = torch.zeros_like(pix)
    o, d, t = cam.generate_rays(cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, dev)),
                                pix, smp, SEED, motion_blur=scene.flags.has_moving)
    monkeypatch.setattr(pool_mod, "POOL_SIZE", 4096)

    def capture():
        if what == "trace":
            def body():
                trace_megakernel(mega, o, d, t, pix, smp, cfg.background, cfg.max_depth, SEED,
                                 phase_depths=[2, 3, 3])

            return graphs._capture(body, body, dev, keep_graph=True)
        prog = pool_mod.program(mega, cfg, SEED, fused=True, pool_size=4096)
        prog.run(lambda: prog.state.init(cam.CameraParams.from_config(cfg, dev), 0))
        return prog.graph

    counts = {}
    try:
        for mode in ("none", "off", "on"):
            pf.enable(mode == "on")
            with monkeypatch.context() as m:
                if mode == "none":
                    for mod in (mk, pool_mod):
                        m.setattr(mod, "stage", lambda name, device: contextlib.nullcontext())
                counts[mode] = _graph_nodes(capture())
    finally:
        pf.enable(False)
        pf.reset_stages()
    # the trace: camera, k1 and compact a phase, accumulate; the pool: k1,
    # compact, bank, camera
    pairs = 8 if what == "trace" else 4
    assert counts["off"] == counts["none"] and counts["off"][1] == 0
    assert counts["on"] == (counts["off"][0] + 2 * pairs, 2 * pairs)
