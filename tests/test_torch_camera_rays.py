"""Camera rays computed where they are used: ``csrc/rt_camera.cuh``
``rt::camera_ray`` (K1's camera start and ``rt_camera_rays``) against
``render/camera.py`` ``generate_rays``, and the paths that take it.

On the CPU: the device function built for the host by a C++ compiler with
``-ffp-contract=off`` (as nvcc's ``-fmad=false``) against
``generate_rays`` on CPU tensors, bit for bit without defocus (the
cornell_box camera) and within 2 ulp with it (bouncing_spheres: the
host's sqrtf, sinf and cosf against PyTorch's); the plain versions of the
camera start (``trace_megakernel(camera=...)``, ``replay_rays``) against
the same traces fed ``generate_rays``; a fused render program replayed at
a second pose. On the card (marked ``cuda``, skipped without one):
``torch.equal`` with ``generate_rays`` at the benchmark cells' launch
shapes, K1 started from the camera against K1 fed the packed rays, a
render and a gradient sweep that never call the int64 PCG4D, with the
two launch counters, and a fused program replayed at two poses.
"""
import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import Renderer, build
from raytracing_tpu_torch.core import rng
from raytracing_tpu_torch.diff import replay_kernel as rk
from raytracing_tpu_torch.ops import megakernel_block as mb
from raytracing_tpu_torch.ops.megakernel import build_mega_scene, pack_rays, trace_megakernel
from raytracing_tpu_torch.render import camera as cam
from raytracing_tpu_torch.render.renderer import chunk_ids

torch.set_num_threads(2)
CSRC = Path(mb.__file__).resolve().parents[1] / "csrc"
SEEDS = (7, 2**31 + 12345, 2**33 + 2**31 + 7)  # the last wraps to u32 as the RNG does

HOST_HARNESS = r"""
#include "rt_camera.cuh"
extern "C" void host_camera_rays(const int* ray_i, int n, const float* cam, uint32_t width,
                                 int flags, uint32_t seed, float* out) {
  for (int i = 0; i < n; ++i) {
    const rt::CameraRay r = rt::camera_ray((uint32_t)ray_i[i], (uint32_t)ray_i[n + i], seed,
                                           cam, width, flags);
    const float v[7] = {r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tm};
    for (int k = 0; k < 7; ++k) out[k * n + i] = v[k];
  }
}
"""


def _derived(cfg, dev, params=None):
    return cam.derive(cfg, params if params is not None else cam.CameraParams.from_config(cfg, dev))


def _start(cfg, dev, moving, params=None):
    return cam.CameraStart.of(cfg, cam.pack_camera(_derived(cfg, dev, params)), moving)


def _launch_ids(cfg, n_block, spp_chunk, dev):
    """Two launches' ids: the first block of the first sample chunk, and
    the last block (padded, its last pixels clamped and dead) of a chunk
    that runs one sample past spp."""
    n_blocks = -(-cfg.n_pixels // n_block)
    first = chunk_ids(cfg, 0, 0, n_block=n_block, spp_chunk=spp_chunk, device=dev)
    last = chunk_ids(cfg, (n_blocks - 1) * n_block, cfg.samples_per_pixel - spp_chunk + 1,
                     n_block=n_block, spp_chunk=spp_chunk, device=dev)
    pix, smp, _, alive = (torch.cat(x) for x in zip(first, last))
    assert int(pix.max()) == cfg.n_pixels - 1 and int(smp.max()) >= cfg.samples_per_pixel
    assert 0 < int(alive.sum()) < alive.numel()
    return pix, smp, alive


@pytest.fixture(scope="module")
def host_camera(tmp_path_factory):
    """``csrc/rt_camera.cuh`` built for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the camera's device function")
    d = tmp_path_factory.mktemp("camera_host")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libcamera.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{CSRC}", str(d / "harness.cpp"), "-o", str(so)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.host_camera_rays.argtypes = [P, I, P, U, I, U, P]
    lib.host_camera_rays.restype = None
    return lib


@pytest.mark.parametrize("name", ["cornell_box", "bouncing_spheres"])
def test_camera_ray_on_the_host_matches_generate_rays(host_camera, name):
    """The device function built for the host against ``generate_rays``
    on CPU tensors, with and without motion blur, at three seeds (one past
    2^31, one past 2^32). Without defocus (cornell_box) every output is
    bit-equal; with it (bouncing_spheres) the pixel samples and times are,
    the origins within 2 ulp and the directions within 2 ulp of the
    origin and one of their own (the host's and PyTorch's sqrt, sin and
    cos may differ by an ulp)."""
    scene, cfg = build(name, device="cpu", image_width=60, samples_per_pixel=2, max_depth=4)
    pix, smp, _ = _launch_ids(cfg, 1024, 2, "cpu")
    ray_i = torch.stack([pix, smp]).to(torch.int32)
    n = pix.numel()
    for motion in (True, False):
        start = _start(cfg, "cpu", motion)
        assert start.defocus == (name == "bouncing_spheres")
        for seed in SEEDS:
            out = torch.empty(7, n)
            host_camera.host_camera_rays(ray_i.data_ptr(), n, start.camera.data_ptr(),
                                         start.width, start.flags, ctypes.c_uint32(seed),
                                         out.data_ptr())
            o, d, t = cam.generate_rays(cfg, _derived(cfg, "cpu"), pix, smp, seed,
                                        motion_blur=motion)
            assert torch.equal(out[6], t)
            if not start.defocus:
                assert torch.equal(out[:3], o.T) and torch.equal(out[3:6], d.T)
                continue
            o_ulp = np.spacing(np.abs(o.T.numpy()))
            assert (np.abs(out[:3].numpy() - o.T.numpy()) <= 2 * o_ulp).all()
            d_tol = 2 * o_ulp + np.spacing(np.abs(d.T.numpy()))
            assert (np.abs(out[3:6].numpy() - d.T.numpy()) <= d_tol).all()


@pytest.mark.parametrize("name,layout,phases,prefixes", [
    ("bouncing_spheres", "block", [1, 2, 3], True),
    ("cornell_box", "block", None, False),
    ("cornell_box", "group", [2, 4], False),
])
def test_camera_start_traces_as_the_rays(name, layout, phases, prefixes):
    """``trace_megakernel(camera=...)`` on CPU tensors (K1's plain version
    packs the camera rays itself, K5 takes them from ``camera.rays``)
    against the same trace fed ``generate_rays``: every output equal, the
    compacted ids, counts and prefix flag too."""
    scene, cfg = build(name, device="cpu", image_width=40, samples_per_pixel=2, max_depth=6)
    mega = build_mega_scene(scene)
    moving = scene.flags.has_moving
    pix, smp, alive = _launch_ids(cfg, 1024, 2, "cpu")
    o, d, t = cam.generate_rays(cfg, _derived(cfg, "cpu"), pix, smp, SEEDS[1],
                                motion_blur=moving)
    kw = dict(phase_depths=phases, active0=alive, layout=layout)
    if layout == "block":
        kw.update(want_ids="compacted", want_counts=True)
    if prefixes:
        kw["phase_prefixes"] = (None, 2048, 1024)
    args = (pix, smp, cfg.background, cfg.max_depth, SEEDS[1])
    ref = trace_megakernel(mega, o, d, t, *args, **kw)
    got = trace_megakernel(mega, None, None, None, *args, **kw,
                           camera=_start(cfg, "cpu", moving))
    assert len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref))
    assert int(got[1]) > 0


def test_replay_rays_on_cpu_tensors_pack_generate_rays():
    """``replay_rays`` on CPU tensors: the replay kernels' packed rays of
    ``generate_rays`` for ids in a permuted order, alive as flagged."""
    scene, cfg = build("bouncing_spheres", device="cpu", image_width=40, samples_per_pixel=2,
                       max_depth=4)
    pix, smp, alive = _launch_ids(cfg, 1024, 2, "cpu")
    order = torch.randperm(pix.numel(), generator=torch.Generator().manual_seed(3))
    pix, smp, alive = pix[order], smp[order], alive[order]
    ray_f = rk.replay_rays(_start(cfg, "cpu", True), torch.stack([pix, smp]).int(), alive,
                           SEEDS[2])
    o, d, t = cam.generate_rays(cfg, _derived(cfg, "cpu"), pix, smp, SEEDS[2])
    assert torch.equal(ray_f, rk.pack_replay_rays(o, d, t, alive))


def _poses(cfg, dev):
    p1 = cam.CameraParams.from_config(cfg, dev)
    shift = torch.tensor([1.5, -0.5, 2.0], device=dev)
    return p1, dataclasses.replace(p1, lookfrom=p1.lookfrom + shift,
                                   lookat=p1.lookat + 0.5 * shift)


def test_fused_render_follows_a_new_pose():
    """One fused render program (``Renderer(fused=True)``) rendering two
    poses in turn gives the images of two unfused renders: the packed
    camera is the program's state, rewritten for each render."""
    scene, cfg = build("cornell_box", device="cpu", image_width=24, samples_per_pixel=2,
                       max_depth=4)
    fused = Renderer(cfg, max_rays_per_launch=1024)
    images = []
    for p in _poses(cfg, "cpu"):
        a = fused.render(scene, p, seed=SEEDS[0])
        b = Renderer(cfg, max_rays_per_launch=1024, fused=False).render(scene, p, seed=SEEDS[0])
        assert a.segments == b.segments
        np.testing.assert_array_equal(a.radiance, b.radiance)
        images.append(a.radiance)
    assert not np.array_equal(*images)


def test_camera_start_refusals():
    """Rays and a camera start are exclusive; the gradient replay takes
    its rays one way (gathered or regenerated) and its ids one way;
    ``alive`` belongs to a camera start and is a bool per lane; the packed
    camera is (18,) f32."""
    scene, cfg = build("cornell_box", device="cpu", image_width=16, samples_per_pixel=1,
                       max_depth=2)
    mega = build_mega_scene(scene)
    pix, smp, _, alive = chunk_ids(cfg, 0, 0, n_block=1024, spp_chunk=1, device="cpu")
    start = _start(cfg, "cpu", False)
    o, d, t = start.rays(pix, smp, 0)
    args = (pix, smp, cfg.background, 2, 0)
    with pytest.raises(ValueError, match="not both"):
        trace_megakernel(mega, o, d, t, *args, camera=start)
    with pytest.raises(ValueError, match="not both"):
        trace_megakernel(mega, None, None, None, *args)
    ray_f, ray_i = pack_rays(o, d, t, pix, smp)
    ids = torch.zeros((2, pix.numel()), dtype=torch.int32)
    replay = (scene, None, cfg.background, 2, 0, None, torch.zeros(pix.numel()))
    with pytest.raises(ValueError, match="rays=.*not both"):
        rk.replay_grads_sorted(*replay, ids=ids, rays=(o, d, t, pix, smp),
                               ray_regen=lambda orig, alive: (ray_f, ray_i))
    with pytest.raises(ValueError, match="rays=.*not both"):
        rk.replay_grads_sorted(*replay, ids=ids)
    with pytest.raises(ValueError, match="ids=.*not both"):
        rk.replay_grads_sorted(*replay, rays=(o, d, t, pix, smp))
    kw = dict(max_depth=2, background=cfg.background)
    with pytest.raises(ValueError, match="ray_f=None"):
        mb.trace_block(mega, ray_f, ray_i, 0, 0, camera=start, **kw)
    with pytest.raises(ValueError, match="alive belongs"):
        mb.trace_block(mega, ray_f, ray_i, 0, 0, alive=alive, **kw)
    with pytest.raises(ValueError, match="alive must be"):
        mb.trace_block(mega, None, ray_i, 0, 0, camera=start, alive=alive.float(), **kw)
    with pytest.raises(ValueError, match="packed camera"):
        mb.trace_block(mega, None, ray_i, 0, 0, camera=dataclasses.replace(
            start, camera=start.camera[:9]), **kw)
    with pytest.raises(ValueError, match="alive must be"):
        rk.replay_rays(start, ray_i, alive.int(), 0)


# ------------------------------------------------------------------ on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


# the benchmark cells' scenes at their sizes (BENCHMARK.json, benchmark/traffic)
CELL_SHAPES = {"bouncing_spheres": dict(image_width=1200, samples_per_pixel=500, max_depth=50),
               "cornell_box": dict(image_width=600, samples_per_pixel=100, max_depth=50)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bouncing_spheres", "cornell_box"])
def test_card_camera_rays_equal_generate_rays(dev, name):
    """On the card, at the cells' launch shape (``Renderer``'s first and
    last launches, the last one padded and clamped, its samples past spp):
    K1's start state (a depth-0 launch started from the camera) equals
    ``pack_rays`` of ``generate_rays``, and ``rt_camera_rays`` on the ids
    in a permuted (sorted-order) list equals ``pack_replay_rays`` of the
    same rays, bit for bit, at three seeds, with and without motion
    blur."""
    scene, cfg = build(name, device=dev, **CELL_SHAPES[name])
    r = Renderer(cfg)
    mega = build_mega_scene(scene)
    pix, smp, alive = _launch_ids(cfg, r.n_block, r.spp_chunk, dev)
    ray_i = torch.stack([pix, smp]).to(torch.int32)
    order = torch.randperm(pix.numel(), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))
    before = (int(mb.camera_launches), int(rk.camera_launches))
    for motion in {scene.flags.has_moving, False}:
        start = _start(cfg, dev, motion)
        for seed in SEEDS:
            o, d, t = cam.generate_rays(cfg, _derived(cfg, dev), pix, smp, seed,
                                        motion_blur=motion)
            _, bc, state = mb.trace_block(mega, None, ray_i, seed, 0, max_depth=0,
                                          background=cfg.background, camera=start, alive=alive)
            assert torch.equal(state, pack_rays(o, d, t, pix, smp, alive)[0])
            assert int(bc.sum()) == 0
            got = rk.replay_rays(start, ray_i[:, order].contiguous(), alive[order], seed)
            assert torch.equal(got, rk.pack_replay_rays(o[order], d[order], t[order],
                                                        alive[order]))
    torch.cuda.synchronize()
    n = 3 * len({scene.flags.has_moving, False})
    assert (int(mb.camera_launches), int(rk.camera_launches)) == (before[0] + n, before[1] + n)


@pytest.mark.cuda
@pytest.mark.parametrize("cull", [False, True], ids=["sweep", "walk"])
def test_card_k1_camera_start_equals_packed_rays(dev, cull):
    """K1 started from the camera against K1 fed ``generate_rays`` through
    ``pack_rays`` on a bouncing_spheres launch of the final render's
    shape: radiance, bounce counts, state and ids equal, by either
    search; and the whole phased trace (compacted ids, counts, planned
    prefixes) started from the camera against the one fed the rays."""
    scene, cfg = build("bouncing_spheres", device=dev, **CELL_SHAPES["bouncing_spheres"])
    mega = build_mega_scene(scene)
    r = Renderer(cfg)
    pix, smp, alive = _launch_ids(cfg, r.n_block, r.spp_chunk, dev)
    start = _start(cfg, dev, True)
    o, d, t = cam.generate_rays(cfg, _derived(cfg, dev), pix, smp, SEEDS[1])
    ray_f, ray_i = pack_rays(o, d, t, pix, smp, alive)
    kw = dict(max_depth=8, background=cfg.background, want_ids=True, cull=cull)
    ref = mb.trace_block(mega, ray_f, ray_i, SEEDS[1], 0, **kw)
    got = mb.trace_block(mega, None, ray_i, SEEDS[1], 0, camera=start, alive=alive, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    args = (pix, smp, cfg.background, 8, SEEDS[1])
    tk = dict(phase_depths=[2, 3, 3], active0=alive, want_ids="compacted", want_counts=True,
              phase_prefixes=(None, 393216, 131072), cull=cull)
    ref = trace_megakernel(mega, o, d, t, *args, **tk)
    got = trace_megakernel(mega, None, None, None, *args, **tk, camera=start)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
def test_card_render_and_sweep_never_call_pcg4d(dev, monkeypatch):
    """A phased render (fused and looped) and a planned gradient sweep on
    the card never run the int64 PCG4D of ``core/rng.py`` (it raises here
    on a CUDA tensor): K1 starts every launch from the camera, one
    ``camera_launches`` a launch, and each sweep chunk regenerates its
    replay's rays in one ``rt_camera_rays`` launch."""
    from raytracing_tpu_torch import bench as pbench

    pcg4d = rng.pcg4d

    def cpu_only(a, *rest):
        if a.is_cuda:
            raise AssertionError("the int64 PCG4D ran on a CUDA tensor")
        return pcg4d(a, *rest)

    monkeypatch.setattr(rng, "pcg4d", cpu_only)
    scene, cfg = build("bouncing_spheres", device=dev, image_width=64, samples_per_pixel=4,
                       max_depth=8)
    r = Renderer(cfg, max_rays_per_launch=2048)
    r.render(scene, seed=SEEDS[1])  # captures
    for fused in (True, False):
        before = (int(mb.launches), int(mb.camera_launches))
        res = Renderer(cfg, max_rays_per_launch=2048, fused=fused).render(scene, seed=SEEDS[1]) \
            if not fused else r.render(scene, seed=SEEDS[1])
        torch.cuda.synchronize()
        assert int(mb.camera_launches) - before[1] == res.launches > 1
        assert int(mb.launches) - before[0] == 3 * res.launches  # phases [2, 3, 3]
    s = pbench._fwd_bwd_setup(width=64, spp=8, max_depth=8, spp_chunk=2, device=dev)
    s["plan"](fused=True)
    s["sweep"](fused=True)  # captures
    before = (int(mb.camera_launches), int(rk.camera_launches))
    loss, _, _, segs, ok = s["sweep"](fused=True)
    torch.cuda.synchronize()
    assert bool(ok) and int(segs) > 0 and bool(torch.isfinite(loss))
    assert (int(mb.camera_launches) - before[0], int(rk.camera_launches) - before[1]) == \
        (s["n_chunks"], s["n_chunks"])


@pytest.mark.cuda
def test_card_fused_render_follows_a_new_pose(dev):
    """One captured render program replayed at two poses gives the
    images of two unfused renders, bit for bit: the graph reads the pose
    from the packed camera in its state."""
    scene, cfg = build("bouncing_spheres", device=dev, image_width=64, samples_per_pixel=4,
                       max_depth=8)
    fused = Renderer(cfg, max_rays_per_launch=2048)
    images = []
    for p in _poses(cfg, dev):
        a = fused.render(scene, p, seed=SEEDS[0])
        b = Renderer(cfg, max_rays_per_launch=2048, fused=False).render(scene, p, seed=SEEDS[0])
        assert fused.programs.program.graph is not None
        assert a.segments == b.segments
        np.testing.assert_array_equal(a.radiance, b.radiance)
        images.append(a.radiance)
    assert not np.array_equal(*images)
