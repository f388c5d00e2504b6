"""The table fold (the backward of the port's table lookup and the replay's
table reduction) and K3's refilling lanes, on the CPU.

The fold's plain version (``ops/table_gather.fold_torch``, ``index_add_``)
is held against the JAX package's ``table_lookup`` VJP (a one-hot matmul)
and the reference's per-bounce one-hot reduction, on numpy-seeded
cotangents and ids (-1, out of range and repeated), at rtol 1e-5 and atol
2e-6·max(1, B/L): the sums are the same, taken in another order. The
fold kernel's zero-skip rule is checked bit for bit against
``index_add_``. K3's per-ray functions (``csrc/replay_kernel.cu`` without
``__CUDACC__``) are built with g++ and run in the kernel's refilling
schedule, ray by ray in any order, against one ray at a time, bit for bit.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.ops.table_gather import table_lookup as jlookup
from raytracing_tpu_torch import build
from raytracing_tpu_torch.diff import replay_fast as prf
from raytracing_tpu_torch.diff import replay_kernel as rk
from raytracing_tpu_torch.ops import table_gather as tg
from raytracing_tpu_torch.ops.megakernel import build_mega_scene, trace_megakernel
from raytracing_tpu_torch.render import camera as cam

CSRC = Path(rk.__file__).resolve().parents[1] / "csrc"
SEED = 5


def _ids(rng, L, shape):
    """Ids with misses (-1), out-of-range rows and a few hot rows repeated."""
    ids = rng.integers(0, L, shape)
    u = rng.random(shape)
    ids[u < 0.3] = -1
    ids[(u >= 0.3) & (u < 0.35)] = L + rng.integers(0, 5, shape)[(u >= 0.3) & (u < 0.35)]
    ids[(u >= 0.35) & (u < 0.6)] = rng.integers(0, 3, shape)[(u >= 0.35) & (u < 0.6)]
    return ids.astype(np.int32)


def _bar(B, L):
    return dict(rtol=1e-5, atol=2e-6 * max(1, B // L))


@pytest.mark.parametrize("F", [5, 23])
def test_fold_matches_jax_lookup_vjp(F):
    """The lookup's backward (the fold, and autograd through
    ``table_lookup``) against ``jax.vjp`` of the JAX ``table_lookup``."""
    L, B = 128, 4096
    rng = np.random.default_rng(F)
    table = rng.normal(size=(L, F)).astype(np.float32)
    ids = _ids(rng, L, B)
    cot = rng.normal(size=(F, B)).astype(np.float32)
    _, vjp = jax.vjp(lambda tb: jlookup(tb, jnp.asarray(ids)), jnp.asarray(table))
    (want,) = vjp(tuple(jnp.asarray(cot[f]) for f in range(F)))
    want = np.asarray(want)
    before = int(tg.fold_launches)
    got = tg.fold(torch.from_numpy(cot), torch.from_numpy(ids), L)
    assert got.shape == (L, F) and int(tg.fold_launches) == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, **_bar(B, L))
    exact = np.zeros((L, F))
    np.add.at(exact, np.clip(ids, 0, L - 1), cot.T.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, **_bar(B, L))
    tb = torch.from_numpy(table).requires_grad_(True)
    (tg.table_lookup(tb, torch.from_numpy(ids)) * torch.from_numpy(cot)).sum().backward()
    assert torch.equal(tb.grad, got)


def test_batched_fold_with_prefixes_matches_onehot():
    """The fold's batched form (one call for D bounces, each cut to its
    prefix) and ``reduce_table_grads`` on it, against the reference's
    one-hot matmul per bounce."""
    L, D, n = 128, 6, 4096
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(D, rk.NG, n)).astype(np.float32))
    ids = torch.from_numpy(_ids(rng, L, (D, n)).clip(-1, L - 1))
    prefixes = (4096, 3072, 1024, 0, 1000, 33)
    acc = torch.zeros((L, rk.NG))
    for b, P in enumerate(prefixes):
        acc += (torch.arange(L)[:, None] == ids[b, :P].clamp(min=0)[None, :]).float() @ \
            g[b, :, :P].T
    torch.testing.assert_close(tg.fold(g, ids, L, prefixes), acc, **_bar(n, L))
    tbar = torch.zeros((L, prf.N_FIELDS))
    tbar[:, rk._TCOLS] = acc[:, rk._GSLOTS]
    torch.testing.assert_close(rk.reduce_table_grads(g, ids, L, prefixes), tbar, **_bar(n, L))
    assert torch.equal(tg.fold(g, ids, L), tg.fold(g, ids, L, [n] * D))


def test_fold_windows_split_deep_chunks():
    """A chunk deeper than FOLD_MAX_D bounces folds in windows of at most 64
    consecutive bounces, one launch each (a window whose prefixes are all 0
    is not launched, and D <= 64 stays one launch); the windows' folds,
    added into one table, equal the reference's one-hot reduction of all
    72 bounces at the fold's bar."""
    assert tg.FOLD_MAX_D == 64
    P = [2048 - 25 * b for b in range(72)]
    assert tg.fold_windows(72, P) == [(0, P[:64]), (64, P[64:])]
    assert tg.fold_windows(64, P[:64]) == [(0, P[:64])]
    assert tg.fold_windows(1, [7]) == [(0, [7])]
    assert [(w0, len(p)) for w0, p in tg.fold_windows(130, [1] * 130)] == [(0, 64), (64, 64),
                                                                          (128, 2)]
    cut = P[:64] + [0] * 8
    assert tg.fold_windows(72, cut) == [(0, P[:64])]
    assert tg.fold_windows(72, [0] * 64 + P[64:]) == [(64, P[64:])]
    assert tg.fold_windows(72, [0] * 72) == []
    with pytest.raises(ValueError, match="one prefix per bounce"):
        tg.fold_windows(72, P[:64])
    L, D, n = 128, 72, 2048
    rng = np.random.default_rng(6)
    g = torch.from_numpy(rng.normal(size=(D, rk.NG, n)).astype(np.float32))
    ids = torch.from_numpy(_ids(rng, L, (D, n)))
    acc = torch.zeros((L, rk.NG))
    for b, Pb in enumerate(P):
        acc += (torch.arange(L)[:, None] == ids[b, :Pb].clamp(0, L - 1)[None, :]).float() @ \
            g[b, :, :Pb].T
    windowed = torch.zeros((L, rk.NG))
    for w0, Pw in tg.fold_windows(D, P):
        w1 = w0 + len(Pw)
        windowed += tg.fold(g[w0:w1], ids[w0:w1], L, Pw)
    torch.testing.assert_close(windowed, acc, **_bar(sum(P), L))
    torch.testing.assert_close(tg.fold(g, ids, L, P), acc, **_bar(sum(P), L))


def test_zero_skip_is_exact():
    """The fold kernel skips a ray whose cotangents are all zero and a zero
    field: ``index_add_`` over every ray equals it over the rays with a
    nonzero cotangent only, bit for bit, with -0.0 cotangents among them,
    and a row that receives only zeros stays +0.0."""
    L, F, B = 64, 23, 4096
    rng = np.random.default_rng(2)
    g = rng.normal(size=(F, B)).astype(np.float32)
    g[:, rng.random(B) < 0.7] = 0.0
    g[rng.random((F, B)) < 0.3] = 0.0
    g[:, rng.random(B) < 0.1] = -0.0
    g[rng.random((F, B)) < 0.1] *= -0.0
    ids = _ids(rng, L, B)
    zero_row = 7
    ids[ids == zero_row] = 8
    ids[np.flatnonzero(~g.any(0))[:50]] = zero_row  # row 7 gets zero cotangents only
    gt, it = torch.from_numpy(g), torch.from_numpy(ids)
    full = tg.fold(gt, it, L)
    keep = (gt != 0).any(0)
    skipped = torch.zeros((L, F)).index_add_(0, it[keep].clamp(0, L - 1).long(), gt[:, keep].T)
    assert torch.equal(full, skipped)
    assert torch.equal(full.view(torch.int32), skipped.view(torch.int32))  # signs too
    assert not bool((torch.signbit(full) & (full == 0)).any())  # no sum is -0.0
    assert bool((full[zero_row] == 0).all())
    positive = torch.where(gt == 0, torch.zeros_like(gt), gt)  # -0.0 -> +0.0
    assert torch.equal(full.view(torch.int32), tg.fold(positive, it, L).view(torch.int32))


REFILL_HARNESS = r"""
#include <vector>
#include "replay_kernel.cu"
// K3's per-ray functions in the kernel's refilling schedule: `lanes` lanes
// run one bounce each per round, and a lane whose ray ends writes it and
// takes the next ray of `order`.
extern "C" void host_refill(const float* table, const int* ids, const float* ray_f,
    const int* ray_i, const int* maxlen, int n, int D, int n_sph, int moving, uint32_t seed,
    float bg_r, float bg_g, float bg_b, float* out_rad, int* out_bc, const int* order,
    int lanes) {
  ReplayParams p{table, ids, ray_f, ray_i, maxlen, nullptr, n, D, n_sph, seed, bg_r, bg_g,
                 bg_b, out_rad, out_bc, nullptr};
  std::vector<int> ray(lanes, -1);
  std::vector<FwdLane> st(lanes);
  int next = 0;
  for (bool busy = true; busy;) {
    busy = false;
    for (int k = 0; k < lanes; ++k) {
      if (ray[k] < 0 && next < n) fwd_start(p, ray[k] = order[next++], st[k]);
      if (ray[k] < 0) continue;
      busy = true;
      if (fwd_running(st[k])) {
        const int id = recorded_id(p, ray[k], st[k].bc);
        if (moving) fwd_step<true>(p, id, st[k]); else fwd_step<false>(p, id, st[k]);
      }
      if (!fwd_running(st[k])) { fwd_finish(p, ray[k], st[k]); ray[k] = -1; }
    }
  }
}
extern "C" void host_per_ray(const float* table, const int* ids, const float* ray_f,
    const int* ray_i, const int* maxlen, int n, int D, int n_sph, int moving, uint32_t seed,
    float bg_r, float bg_g, float bg_b, float* out_rad, int* out_bc) {
  ReplayParams p{table, ids, ray_f, ray_i, maxlen, nullptr, n, D, n_sph, seed, bg_r, bg_g,
                 bg_b, out_rad, out_bc, nullptr};
  for (int i = 0; i < n; ++i) {
    if (moving) replay_fwd_ray<true>(p, i); else replay_fwd_ray<false>(p, i);
  }
}
"""


@pytest.fixture(scope="module")
def host_refill(tmp_path_factory):
    """K3's source built for the host without FMA contraction."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernels' per-ray math")
    d = tmp_path_factory.mktemp("refillhost")
    (d / "harness.cpp").write_text(REFILL_HARNESS)
    so = d / "librefillhost.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{CSRC}", str(d / "harness.cpp"), "-o", str(so)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    common = [P, P, P, P, P, I, I, I, I, U, F, F, F, P, P]
    lib.host_refill.argtypes = common + [P, I]
    lib.host_per_ray.argtypes = common
    lib.host_refill.restype = lib.host_per_ray.restype = None
    return lib


@pytest.mark.parametrize("name", ["bouncing_spheres", "cornell_box"])
def test_refilling_lanes_match_one_ray_at_a_time(host_refill, name):
    """K3's rays run in the refilling schedule (7 lanes; rays taken in
    order and in a shuffled order) give every ray the radiance and bounce
    count of the one-ray-at-a-time replay bit for bit, and the plain
    version's segments."""
    depth = 6
    scene, cfg = build(name, device="cpu", image_width=32, samples_per_pixel=1,
                       max_depth=depth)
    B = -(-cfg.n_pixels // 1024) * 1024
    pix = torch.clamp(torch.arange(B), max=cfg.n_pixels - 1)
    smp = torch.zeros_like(pix)
    act = torch.arange(B) < cfg.n_pixels
    o, d, tm = cam.generate_rays(cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, "cpu")),
                                 pix, smp, SEED, motion_blur=scene.flags.has_moving)
    _, _, ids, cnt = trace_megakernel(build_mega_scene(scene), o, d, tm, pix, smp,
                                      cfg.background, depth, SEED, active0=act, want_ids=True,
                                      want_counts=True)
    table = prf.build_replay_table(scene).detach()
    ray_f = rk.pack_replay_rays(o, d, tm, act)
    ray_i = torch.stack([pix, smp]).to(torch.int32)
    maxlen = rk.tile_maxlen(cnt, depth)
    ids = ids.to(torch.int32).contiguous()
    args = (table.data_ptr(), ids.data_ptr(), ray_f.data_ptr(), ray_i.data_ptr(),
            maxlen.data_ptr(), B, depth, scene.n_spheres, int(scene.flags.has_moving), SEED,
            *cfg.background)
    rad, bc = torch.empty(3, B), torch.empty(B, dtype=torch.int32)
    host_refill.host_per_ray(*args, rad.data_ptr(), bc.data_ptr())
    for order in (torch.arange(B, dtype=torch.int32),
                  torch.from_numpy(np.random.default_rng(0).permutation(B).astype(np.int32))):
        rad_r, bc_r = torch.full((3, B), float("nan")), torch.full((B,), -1, dtype=torch.int32)
        host_refill.host_refill(*args, rad_r.data_ptr(), bc_r.data_ptr(), order.data_ptr(), 7)
        assert torch.equal(rad_r.view(torch.int32), rad.view(torch.int32))
        assert torch.equal(bc_r, bc)
    _, bc_p = rk.replay_fwd_torch(table, ids, ray_f, ray_i, maxlen, seed=SEED,
                                  n_sph=scene.n_spheres, has_moving=scene.flags.has_moving,
                                  background=cfg.background)
    assert int(bc.sum()) == int(bc_p.sum()) > B // 2
