"""The port's CUDA kernel on the card: K1 against its plain PyTorch version
and a render on the card against the same render on the CPU. Marked
``cuda``; each test skips when no CUDA device is present. On a GPU
machine:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from raytracing_tpu_torch import Renderer, build
from raytracing_tpu_torch.ops import megakernel_block as mb
from raytracing_tpu_torch.ops.megakernel import build_mega_scene, pack_rays
from raytracing_tpu_torch.render import camera as cam
from torch_parity import segments_close

pytestmark = pytest.mark.cuda
SEED = 7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name,exact", [
    ("three_spheres", True), ("cornell_box", True), ("bouncing_spheres", False)])
@pytest.mark.parametrize("b_off", [0, 3])
def test_kernel_matches_plain_version(dev, name, exact, b_off):
    scene, cfg = build(name, device=dev, image_width=64, samples_per_pixel=1, max_depth=6)
    mega = build_mega_scene(scene)
    B = -(-cfg.n_pixels // 1024) * 1024
    pix = torch.clamp(torch.arange(B, device=dev), max=cfg.n_pixels - 1)
    smp = torch.zeros_like(pix)
    o, d, t = cam.generate_rays(cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, dev)),
                                pix, smp, SEED, motion_blur=scene.flags.has_moving)
    ray_f, ray_i = pack_rays(o, d, t, pix, smp)
    args = (mega, ray_f, ray_i, SEED, b_off)
    kw = dict(max_depth=6, background=cfg.background)
    before = mb.launches
    rad, bc, state = mb.trace_block(*args, **kw)
    torch.cuda.synchronize()
    assert mb.launches == before + 1
    rad_p, bc_p, state_p = mb.trace_block_torch(*args, **kw)
    diff = (rad - rad_p).abs()
    assert (diff.max() < 1e-5) if exact else (diff.mean() < 2e-3)
    assert segments_close(bc_p.sum(), bc.sum())
    assert torch.isfinite(state).all()


def test_render_on_card_matches_cpu(dev):
    kw = dict(image_width=48, samples_per_pixel=2, max_depth=8)
    s_gpu, cfg = build("bouncing_spheres", device=dev, **kw)
    s_cpu, _ = build("bouncing_spheres", **kw)
    r = Renderer(cfg, phase_depths=[2, 2, 4])
    g = r.render(s_gpu, seed=SEED)
    c = r.render(s_cpu, seed=SEED)
    assert np.abs(g.radiance - c.radiance).mean() < 2e-3
    assert segments_close(c.segments, g.segments)
