"""The port's decision replay (K3 forward, K2 backward, the table
reduction and the fwd+bwd bench chunk) against the JAX package.

The same inputs go to both packages: rays and ids recorded by JAX's XLA
decision pass (``record_decisions``) at width 32, spp 1, depth 6, B =
2048, and a numpy-seeded radiance cotangent. The JAX side runs its XLA
paths (``replay_trace_fast`` and ``jax.vjp`` of it, ``lax.scan`` over the
bounces), jitted with torch_parity.FAST_COMPILE. The deep scene
(torch_parity.deep_scene: the camera inside a fuzz-0 metal sphere) runs
at depth 72, so that some rays replay past 64 bounces.

Bars (tests/test_replay_kernel.py): radiance max |Δ| < 1e-5 on
three_spheres and cornell_box, mean |Δ| < 2e-3 on bouncing_spheres;
segments within max(4, s/200); gradients at rtol 3e-5, atol 3e-6. XLA on
the CPU contracts multiply-adds into FMAs and the port does not, which
can flip a Schlick or metal-absorb decision on a rare ray: rays whose
radiance differs by more than 1e-4 are counted, capped at max(4, B/200),
and left out of the gradient comparison (their cotangent is zeroed on
both sides).
"""
import ctypes
import dataclasses
import functools
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.diff.replay import record_decisions
from raytracing_tpu.diff.replay_fast import replay_trace_fast
from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.render import camera as jcam
from raytracing_tpu.render.camera import CameraConfig as JCameraConfig
from raytracing_tpu.scene.builder import SceneBuilder as JSceneBuilder
from raytracing_tpu_torch.diff import replay_fast as prf
from raytracing_tpu_torch.diff import replay_kernel as rk
from raytracing_tpu_torch.ops.megakernel import build_mega_scene, trace_megakernel
from torch_parity import deep_scene, deep_scene_config, jit_run, port_scene, segments_close, t

torch.set_num_threads(2)
B = 2048
DEPTH = 6
DEEP_DEPTH = 72  # the deep scene's: past 64 bounces
SEED = 5
CSRC = Path(rk.__file__).resolve().parents[1] / "csrc"


def _setup(name):
    scene, cfg, r, rad_bar = _recorded(name)
    return scene, cfg, r, rad_bar.copy()


def _depth(name):
    return DEEP_DEPTH if name == "deep" else DEPTH


@functools.lru_cache(maxsize=None)
def _recorded(name):
    """Camera rays and JAX-recorded ids of one scene (shared by the tests)."""
    depth = _depth(name)
    if name == "deep":
        scene, cfg = deep_scene(JSceneBuilder()).compile(), deep_scene_config(JCameraConfig)
    else:
        scene, cfg = jbuild(name, image_width=32, samples_per_pixel=1, max_depth=depth)
    n_pix = cfg.n_pixels
    pix = jnp.minimum(jnp.arange(B, dtype=jnp.int32), n_pix - 1)
    smp = jnp.zeros((B,), jnp.int32)
    act0 = jnp.arange(B) < n_pix
    derived = jcam.derive(cfg, jcam.CameraParams.from_config(cfg))
    o, d, tm = jcam.generate_rays(cfg, derived, pix, smp, jnp.uint32(SEED),
                                  motion_blur=scene.flags.has_moving)
    bg = jnp.asarray(cfg.background, jnp.float32)
    ids = jit_run(lambda *a: record_decisions(scene, *a, bg, depth, jnp.uint32(SEED),
                                              active0=act0), o, d, tm, pix, smp)
    rad_bar = np.random.default_rng(3).normal(size=(B, 3)).astype(np.float32)
    return scene, cfg, dict(ids=ids, o=o, d=d, tm=tm, pix=pix, smp=smp, act0=act0, bg=bg), rad_bar


GRAD_FIELDS = (("spheres", "center"), ("spheres", "velocity"), ("spheres", "radius"),
               ("textures", "rgb"), ("materials", "fuzz"), ("materials", "ior"),
               ("quads", "q"), ("quads", "u"), ("quads", "v"))


def _with(scene, values):
    """``scene`` with the GRAD_FIELDS replaced by ``values`` (either package)."""
    groups = {}
    for (group, name), v in zip(GRAD_FIELDS, values):
        groups.setdefault(group, {})[name] = v
    if hasattr(scene, "replace"):  # JAX
        return scene.replace(**{g: getattr(scene, g).replace(**kw) for g, kw in groups.items()})
    return dataclasses.replace(scene, **{g: dataclasses.replace(getattr(scene, g), **kw)
                                         for g, kw in groups.items()})


def _port_replay(scene_p, r, values, depth=DEPTH, **kw):
    return rk.replay_trace_kernel(
        _with(scene_p, values), t(r["ids"]), t(r["o"]), t(r["d"]), t(r["tm"]), t(r["pix"]),
        t(r["smp"]), np.asarray(r["bg"]), depth, SEED, active0=t(r["act0"]), **kw)


@pytest.mark.parametrize("name", ["three_spheres", "cornell_box", "bouncing_spheres", "deep"])
def test_replay_and_grads_match_jax(name):
    """The port's replay (its plain versions on the CPU) against the JAX
    XLA replay, radiance, segments and gradients; the deep scene at depth
    72, past the 64 bounces the replay kernels once held."""
    scene, cfg, r, rad_bar = _setup(name)
    depth = _depth(name)
    if name == "deep":
        assert int((np.asarray(r["ids"])[64:] >= 0).any(axis=0).sum()) > 0

    def f(*vals):
        return replay_trace_fast(_with(scene, vals), r["ids"], r["o"], r["d"], r["tm"],
                                 r["pix"], r["smp"], r["bg"], depth, jnp.uint32(SEED),
                                 active0=r["act0"])

    jvals = [getattr(getattr(scene, g), f_) for g, f_ in GRAD_FIELDS]
    rad_j, seg_j = jit_run(f, *jvals)
    scene_p = port_scene(scene)
    pvals = [getattr(getattr(scene_p, g), f_).clone().requires_grad_(True)
             for g, f_ in GRAD_FIELDS]
    rad_p, seg_p = _port_replay(scene_p, r, pvals, depth)
    diff = np.abs(rad_p.detach().numpy() - np.asarray(rad_j))
    if name == "bouncing_spheres":
        assert diff.mean() < 2e-3, diff.mean()
    else:
        assert diff.max() < 1e-5, diff.max()
    assert segments_close(int(seg_j), int(seg_p)), (int(seg_j), int(seg_p))
    flipped = diff.max(axis=1) > 1e-4
    assert flipped.sum() <= max(4, B // 200), flipped.sum()
    rad_bar[flipped] = 0.0

    grads_j = jit_run(lambda rb, *v: jax.vjp(f, *v)[1]((rb, np.zeros((), jax.dtypes.float0))),
                      jnp.asarray(rad_bar), *jvals)
    (rad_p * torch.from_numpy(rad_bar)).sum().backward()
    for (g, f_), gj, pv in zip(GRAD_FIELDS, grads_j, pvals):
        np.testing.assert_allclose(pv.grad.numpy(), np.asarray(gj), rtol=3e-5, atol=3e-6,
                                   err_msg=f"{g}.{f_}")
    # with the decisions fixed, throughput is a product of albedos and the sky is
    # constant, so geometry gets zero gradient in both packages; the rgbs do not
    assert float(pvals[3].grad.abs().sum()) > 0


def _decision(name, phases=None, **kw):
    """Port inputs with ids, counts and radiance from the port's own
    decision pass (K1's plain version)."""
    scene, cfg, r, rad_bar = _setup(name)
    scene_p = port_scene(scene)
    rays = {k: t(r[k]) for k in ("o", "d", "tm", "pix", "smp", "act0")}
    out = trace_megakernel(build_mega_scene(scene_p), rays["o"], rays["d"], rays["tm"],
                           rays["pix"], rays["smp"], cfg.background, _depth(name), SEED,
                           phase_depths=phases, active0=rays["act0"], want_counts=True, **kw)
    return scene_p, cfg, rays, torch.from_numpy(rad_bar), out


def _kernel_grads(scene_p, cfg, rays, ids, rad_bar, linear=False, **kw):
    c = scene_p.spheres.center.clone().requires_grad_(True)
    rgb = scene_p.textures.rgb.clone().requires_grad_(True)
    s = dataclasses.replace(scene_p, spheres=dataclasses.replace(scene_p.spheres, center=c),
                            textures=dataclasses.replace(scene_p.textures, rgb=rgb))
    rad, seg = rk.replay_trace_kernel(s, ids, rays["o"], rays["d"], rays["tm"], rays["pix"],
                                      rays["smp"], cfg.background, DEPTH, SEED,
                                      active0=rays["act0"], **kw)
    loss = (rad * rad_bar).sum() if linear else (rad * rad).sum()
    loss.backward()
    return rad.detach(), int(seg), c.grad, rgb.grad


@pytest.mark.parametrize("name", ["bouncing_spheres", "cornell_box"])
def test_gating_and_radiance_in_are_exact(name):
    """Tile gating from the recorded lengths is bit-identical to the
    ungated replay (radiance, segments, gradients); ``radiance_in``
    returns the given radiance and the recorded segments without the
    forward, and with a linear loss the gradients stay bit-identical."""
    scene_p, cfg, rays, rad_bar, (mrad, mseg, ids, cnt) = _decision(name, want_ids=True)
    assert int(cnt.sum()) == int(mseg)
    r0, s0, *g0 = _kernel_grads(scene_p, cfg, rays, ids, rad_bar)
    r1, s1, *g1 = _kernel_grads(scene_p, cfg, rays, ids, rad_bar, lengths=cnt)
    assert torch.equal(r0, r1) and s0 == s1
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    lin = _kernel_grads(scene_p, cfg, rays, ids, rad_bar, linear=True, lengths=cnt)
    pre = _kernel_grads(scene_p, cfg, rays, ids, rad_bar, linear=True, lengths=cnt,
                        radiance_in=mrad)
    assert torch.equal(pre[0], mrad) and pre[1] == int(mseg)
    for a, b in zip(lin[2:], pre[2:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["bouncing_spheres", "cornell_box"])
def test_replay_grads_sorted_variants(name):
    """The sorted gradient pass against the autograd function's gradients
    (reduction order differs: tolerance), with and without a prefix plan;
    ray_regen and the compacted bundle bit-equal to the gathered columns;
    a violated plan flags ok=False."""
    phases = [2, 2, 2]
    scene_p, cfg, rays, rad_bar, out = _decision(name, phases, want_ids="compacted")
    _, _, ids0, later, perm, cnt, cnt_c = out
    cam_later = torch.empty_like(later)
    cam_later[:, perm] = later
    ids = torch.cat([ids0, cam_later])
    _, _, gc_ref, gr_ref = _kernel_grads(scene_p, cfg, rays, ids, rad_bar, linear=True,
                                         lengths=cnt)

    def run(prefixes=None, regen=False, compacted=False):
        c = scene_p.spheres.center.clone().requires_grad_(True)
        rgb = scene_p.textures.rgb.clone().requires_grad_(True)
        s = dataclasses.replace(scene_p, spheres=dataclasses.replace(scene_p.spheres, center=c),
                                textures=dataclasses.replace(scene_p.textures, rgb=rgb))
        table = prf.build_replay_table(s)
        bundle = dict(ids0=ids0, later=later, perm=perm, counts_c=cnt_c, phase_depths=phases)
        ray_regen = ((lambda i, alive: (
            rk.pack_replay_rays(*(rays[k][i] for k in ("o", "d", "tm")), alive),
            torch.stack([rays["pix"][i], rays["smp"][i]]).int()))
                     if regen or compacted else None)
        tbar, ok = rk.replay_grads_sorted(
            scene_p, table, cfg.background, DEPTH, SEED, rad_bar, cnt,
            ids=None if compacted else ids,
            rays=None if ray_regen else tuple(rays[k] for k in ("o", "d", "tm", "pix", "smp")),
            ray_regen=ray_regen, prefixes=prefixes, compacted=bundle if compacted else None)
        gc, gr = torch.autograd.grad(table, (c, rgb), tbar)
        return tbar, bool(ok), gc, gr

    tbar, ok, gc, gr = run()
    assert ok
    torch.testing.assert_close(gc, gc_ref, rtol=3e-5, atol=3e-6)
    torch.testing.assert_close(gr, gr_ref, rtol=3e-5, atol=3e-6)
    prefixes = rk.plan_prefixes(np.bincount(cnt.numpy(), minlength=DEPTH + 1), B, DEPTH,
                                margin=1.0)
    assert min(prefixes) < B
    tb_p, ok_p, _, _ = run(prefixes)
    assert ok_p and torch.equal(tb_p, tbar)  # the cut rows add exact zeros, in order
    tb_rg, ok_rg, _, _ = run(prefixes, regen=True)
    tb_c, ok_c, _, _ = run(prefixes, compacted=True)
    assert ok_rg and ok_c and torch.equal(tb_rg, tb_p) and torch.equal(tb_c, tb_p)
    assert not run((0,) + prefixes[1:])[1]


def _scene_const_fields(scene):
    """Packed-table fields that the scene's structure makes constant, with
    the value the JAX kernels use in place of a table read
    (``raytracing_tpu.diff.replay_kernel.scene_const_fields``)."""
    const = {}
    if scene.n_quads == 0:
        const.update({prf._F_ISQUAD: 0.0, prf._F_QN: 0.0, prf._F_QN + 1: 0.0,
                      prf._F_QN + 2: 0.0, prf._F_QD: 0.0})
    if not scene.flags.has_moving:
        const.update({prf._F_G1: 0.0, prf._F_G1 + 1: 0.0, prf._F_G1 + 2: 0.0})
    if not scene.flags.has_checker:
        const.update({prf._F_ISCHK: 0.0, prf._F_INVSC: 0.0, prf._F_RGB_O: 0.0,
                      prf._F_RGB_O + 1: 0.0, prf._F_RGB_O + 2: 0.0})
    return const


def _onehot_reduce(g, ids, L, prefixes):
    """The reference's table reduction: a one-hot matmul per bounce, f32."""
    acc = torch.zeros((L, rk.NG))
    for b in range(g.shape[0]):
        P = prefixes[b]
        acc += (torch.arange(L)[:, None] == ids[b, :P].clamp(min=0)[None, :]).float() @ g[b, :, :P].T
    tbar = torch.zeros((L, prf.N_FIELDS))
    tbar[:, rk._TCOLS] = acc[:, rk._GSLOTS]
    return tbar


@pytest.mark.parametrize("name", ["three_spheres", "cornell_box"])
def test_scene_const_fields_do_not_change_the_replay(name):
    """The JAX kernels use scene_const_fields in place of table reads; the
    port reads the table. Overwriting those columns with the constants
    leaves radiance, counts and cotangents unchanged (a field either holds
    its constant or is never read: velocity in a static scene, odd rgb
    without checkers)."""
    scene_p, cfg, rays, rad_bar, (_, _, ids, cnt) = _decision(name, want_ids=True)
    table = prf.build_replay_table(scene_p).detach()
    const = _scene_const_fields(scene_p)
    assert const
    table_c = table.clone()
    for f, v in const.items():
        table_c[:, f] = v
    ray_f = rk.pack_replay_rays(rays["o"], rays["d"], rays["tm"], rays["act0"])
    ray_i = torch.stack([rays["pix"], rays["smp"]]).to(torch.int32)
    maxlen = rk.tile_maxlen(cnt, DEPTH)
    kw = dict(seed=SEED, n_sph=scene_p.n_spheres, has_moving=scene_p.flags.has_moving,
              background=cfg.background)
    for tab in (table, table_c):
        out = rk.replay_fwd_torch(tab, ids, ray_f, ray_i, maxlen, **kw)
        g = rk.replay_bwd_torch(tab, ids, ray_f, ray_i, rad_bar.T.contiguous(), maxlen, **kw)
        if tab is table:
            ref = (out, g)
    assert torch.equal(out[0], ref[0][0]) and torch.equal(out[1], ref[0][1])
    assert torch.equal(g, ref[1])


@pytest.mark.parametrize("name", ["bouncing_spheres", "cornell_box"])
def test_index_add_reduction_matches_onehot(name):
    """reduce_table_grads (``index_add_``) against the reference's one-hot
    matmul over a planned prefix cut, within f32 reassociation."""
    scene_p, cfg, rays, rad_bar, (_, _, ids, cnt) = _decision(name, want_ids=True)
    table = prf.build_replay_table(scene_p).detach()
    order = torch.argsort((DEPTH - cnt.long()) * B + torch.arange(B))
    ids_s, len_s = ids[:, order].contiguous(), cnt[order]
    ray_f = rk.pack_replay_rays(rays["o"][order], rays["d"][order], rays["tm"][order],
                                len_s > 0)
    ray_i = torch.stack([rays["pix"][order], rays["smp"][order]]).to(torch.int32)
    g = rk.replay_bwd_torch(table, ids_s, ray_f, ray_i, rad_bar[order].T.contiguous(),
                            rk.tile_maxlen(len_s, DEPTH), seed=SEED, n_sph=scene_p.n_spheres,
                            has_moving=scene_p.flags.has_moving, background=cfg.background)
    prefixes = rk.plan_prefixes(np.bincount(cnt.numpy(), minlength=DEPTH + 1), B, DEPTH,
                                margin=1.0)
    assert min(prefixes) < B
    L = table.shape[0]
    torch.testing.assert_close(rk.reduce_table_grads(g, ids_s, L, prefixes),
                               _onehot_reduce(g, ids_s, L, prefixes), rtol=1e-5, atol=1e-7)


HOST_HARNESS = r"""
#include "replay_kernel.cu"
extern "C" void host_replay(int bwd, const float* table, const int* ids, const float* ray_f,
    const int* ray_i, const int* maxlen, const float* rad_bar, int n, int D, int n_sph,
    int moving, uint32_t seed, float bg_r, float bg_g, float bg_b, float* out_rad,
    int* out_bc, float* out_g) {
  ReplayParams p{table, ids, ray_f, ray_i, maxlen, rad_bar, n, D, n_sph, seed, bg_r, bg_g,
                 bg_b, out_rad, out_bc, out_g};
  for (int i = 0; i < n; ++i) {
    if (bwd) { if (moving) replay_bwd_ray<true>(p, i); else replay_bwd_ray<false>(p, i); }
    else { if (moving) replay_fwd_ray<true>(p, i); else replay_fwd_ray<false>(p, i); }
  }
}
"""


@pytest.fixture(scope="module")
def host_replay(tmp_path_factory):
    """The K3/K2 source's per-ray math (csrc/replay_kernel.cu without
    __CUDACC__) built for the host without FMA contraction."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernels' per-ray math")
    d = tmp_path_factory.mktemp("replayhost")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libreplayhost.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{CSRC}", str(d / "harness.cpp"), "-o", str(so)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.host_replay.argtypes = [I, P, P, P, P, P, P, I, I, I, I, U, F, F, F, P, P, P]
    lib.host_replay.restype = None
    return lib


@pytest.mark.parametrize("name", ["three_spheres", "cornell_box", "bouncing_spheres", "deep"])
def test_kernel_source_on_the_host_matches_plain(host_replay, name):
    """K3's and K2's arithmetic compiled for the CPU against the plain
    versions: radiance and counts at the forward bars, K2's per-(bounce,
    ray) cotangents reduced to the table at rtol 3e-5, atol 3e-6 (host
    libm and PyTorch may differ by an ulp in sin/cos). The deep scene
    replays 72 bounces, past 64: K2's stash holds any depth."""
    scene_p, cfg, rays, rad_bar, (_, _, ids, cnt) = _decision(name, want_ids=True)
    depth = _depth(name)
    assert name != "deep" or int((cnt > 64).sum()) > 0
    table = prf.build_replay_table(scene_p).detach()
    ray_f = rk.pack_replay_rays(rays["o"], rays["d"], rays["tm"], rays["act0"])
    ray_i = torch.stack([rays["pix"], rays["smp"]]).to(torch.int32)
    maxlen = rk.tile_maxlen(cnt, depth)
    rb = rad_bar.T.contiguous()
    kw = dict(seed=SEED, n_sph=scene_p.n_spheres, has_moving=scene_p.flags.has_moving,
              background=cfg.background)
    rad, bc = torch.empty(3, B), torch.empty(B, dtype=torch.int32)
    g = torch.empty(depth, rk.NG, B)
    args = (table.data_ptr(), ids.data_ptr(), ray_f.data_ptr(), ray_i.data_ptr(),
            maxlen.data_ptr(), rb.data_ptr(), B, depth, scene_p.n_spheres,
            int(scene_p.flags.has_moving), SEED, *cfg.background)
    host_replay.host_replay(0, *args, rad.data_ptr(), bc.data_ptr(), None)
    host_replay.host_replay(1, *args, None, None, g.data_ptr())
    rad_p, bc_p = rk.replay_fwd_torch(table, ids, ray_f, ray_i, maxlen, **kw)
    diff = (rad - rad_p).abs()
    assert (diff.mean() < 2e-3) if name == "bouncing_spheres" else (diff.max() < 1e-5)
    assert segments_close(int(bc_p.sum()), int(bc.sum()))
    g_p = rk.replay_bwd_torch(table, ids, ray_f, ray_i, rb, maxlen, **kw)
    L = table.shape[0]
    torch.testing.assert_close(rk.reduce_table_grads(g, ids, L),
                               rk.reduce_table_grads(g_p, ids, L), rtol=3e-5, atol=3e-6)
