"""The integrator's BVH walk kernel (``csrc/bvh_walk.cu``, ``rt_bvh_walk``)
on the host: its per-ray walk compiled without ``__CUDACC__`` by a C++
compiler with ``-ffp-contract=off`` (no FMA contraction, as nvcc's
``-fmad=false``) and held bit for bit against the plain lockstep walk
(``ops/traverse._traverse``): winner, ``t`` and every ray's node visits,
sphere tests and quad tests, on random scenes of spheres and quads
(moving centres among them), the translated box, bouncing_spheres'
camera and mid-path rays, and rays along the axes and with NaN or
infinite components (the ``1e-20`` direction clamp and the slab test's
NaN propagation). The kernel itself runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 26).
"""
import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import build
from raytracing_tpu_torch.ops import traverse
from raytracing_tpu_torch.ops.intersect import BIG, T_MIN
from raytracing_tpu_torch.scene.builder import SceneBuilder
from torch_parity import AXIS_RAYS, box_scene, bvh_ray_sets, random_rays, random_scene

torch.set_num_threads(2)
CSRC = Path(traverse.__file__).resolve().parents[1] / "csrc"

HOST_HARNESS = r"""
#include "bvh_walk.cu"

extern "C" void host_walk(const float* o, const float* d, const float* time, int B,
    const float* bmin, const float* bmax, const int* prim, const int* miss, int n_nodes,
    const float* sph_c, const float* sph_v, const float* sph_r, int n_sph, const float* q_n,
    const float* q_dc, const float* q_w, const unsigned char* q_degen, const float* q_q,
    const float* q_u, const float* q_v, float t_min, float t_max, int moving,
    long long* best_prim, float* t_best, long long* counts) {
  const WalkScene s{bmin, bmax, prim, miss, n_nodes, sph_c, sph_v, sph_r, n_sph,
                    q_n, q_dc, q_w, q_degen, q_q, q_u, q_v, t_min, t_max, moving};
  for (int i = 0; i < B; ++i) {
    long long c[3] = {0, 0, 0};
    walk_ray<true>(s, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
                   d[3 * i + 2], time[i], t_best[i], best_prim[i], c);
    for (int k = 0; k < 3; ++k) counts[k * B + i] = c[k];
  }
}
"""


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    """``csrc/bvh_walk.cu``'s per-ray walk built for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernel's per-ray walk")
    d = tmp_path_factory.mktemp("bvh_walk_host")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libbvhwalk.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{CSRC}", str(d / "harness.cpp"), "-o", str(so)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.host_walk.argtypes = [P, P, P, I, P, P, P, P, I, P, P, P, I, P, P, P, P, P, P, P, F,
                              F, I, P, P, P]
    lib.host_walk.restype = None
    return lib


def _random(seed, **kw):
    return lambda: random_scene(SceneBuilder(), seed, **kw).compile(device="cpu")


def _np_rays(rays):
    return lambda scene: tuple(torch.from_numpy(x) for x in rays)


def _edge_rays(scene):
    """AXIS_RAYS; rays with a NaN or infinite component; and rays aimed
    along the axes at the first spheres' centres, with the other direction
    components at 0, -0.0 or below the 1e-20 clamp in magnitude."""
    o, d, tm = (torch.from_numpy(x) for x in AXIS_RAYS)
    nan, inf = float("nan"), float("inf")
    o2 = torch.tensor([[nan, 0, 20], [0, 0, 20], [0, 0, 20], [inf, 0, 0]])
    d2 = torch.tensor([[0, 0, -1], [nan, 0, -1], [0, inf, -1], [-1, 0, 0]])
    c = scene.spheres.center[:8]
    tiny = torch.tensor([[1e-21, -0.0, -1], [-1e-21, 1e-30, -1], [-0.0, 0.0, -1],
                         [2e-20, -3e-20, -1]])
    o3 = torch.cat([c + torch.tensor([0.0, 0.0, 25.0]), c + torch.tensor([25.0, 0.0, 0.0])])
    d3 = torch.cat([tiny.repeat(2, 1), tiny[:, [2, 0, 1]].repeat(2, 1)])
    o, d = torch.cat([o, o2, o3]), torch.cat([d, d2, d3])
    return o, d, torch.zeros(o.shape[0])


@functools.lru_cache(maxsize=None)
def _bouncing():
    """bouncing_spheres at 48 px, 2 spp, and its ray sets (torch_parity.bvh_ray_sets)."""
    scene, cfg = build("bouncing_spheres", device="cpu", image_width=48, samples_per_pixel=2,
                       max_depth=4)
    return scene, bvh_ray_sets(scene, cfg)


def _bouncing_rays(name):
    return lambda scene: _bouncing()[1][name]


def _box():
    return box_scene(SceneBuilder(), True).compile(device="cpu")


def _box_rays(scene):
    rng = np.random.default_rng(9)
    o = (rng.uniform(-100, 400, (512, 3)) + np.array([0, 0, -300])).astype(np.float32)
    target = rng.uniform(100, 320, (512, 3)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(target - o), torch.zeros(512)


CASES = {
    "seed0": (_random(0), _np_rays(random_rays(100))),
    "seed1": (_random(1), _np_rays(random_rays(101))),
    "seed2": (_random(2), _np_rays(random_rays(102))),
    "moving": (_random(7, moving=True), _np_rays(random_rays(200))),
    "quads_only": (_random(4, n_spheres=0, n_quads=17), _np_rays(random_rays(104))),
    "translated_box": (_box, _box_rays),
    "bouncing_spheres_camera": (lambda: _bouncing()[0], _bouncing_rays("camera")),
    "bouncing_spheres_mid_path": (lambda: _bouncing()[0], _bouncing_rays("bounce 1")),
    "axis_parallel_nan_inf": (_random(3), _edge_rays),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_walk_on_the_host_matches_plain(host_walk, case):
    make_scene, make_rays = CASES[case]
    scene = make_scene()
    o, d, tm = make_rays(scene)
    B = o.shape[0]
    ref_counts = torch.zeros((3, B), dtype=torch.int64)
    ref_prim, ref_t = traverse._traverse(scene, o, d, tm, T_MIN, BIG, counts=ref_counts)
    _alive, args = traverse.kernel_args(scene, o, d, tm, T_MIN, BIG)
    prim = torch.empty(B, dtype=torch.int64)
    t = torch.empty(B)
    counts = torch.empty((3, B), dtype=torch.int64)
    host_walk.host_walk(*args, prim.data_ptr(), t.data_ptr(), counts.data_ptr())
    assert torch.equal(prim, ref_prim)
    assert torch.equal(t, ref_t)
    assert torch.equal(counts, ref_counts)
    assert int(counts[0].min()) >= 1
    assert int((prim >= 0).sum()) >= 10
    if case == "axis_parallel_nan_inf":
        assert int(prim[4]) == -1 and int(prim[5]) == -1 and int(counts[0, 4]) == 1
    if case.startswith("seed") or case == "moving":  # spheres and quads
        assert int(counts[1].sum()) > 0 and int(counts[2].sum()) > 0
