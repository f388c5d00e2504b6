"""raytracing_tpu_torch core and camera against raytracing_tpu: the PCG4D
hash and the u8 quantizer bit-exact, camera rays to 1e-6."""
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from raytracing_tpu.core import color as jcolor
from raytracing_tpu.core import rng as jrng
from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.render import camera as jcam
from raytracing_tpu_torch.core import color as pcolor
from raytracing_tpu_torch.core import rng as prng
from raytracing_tpu_torch.render import camera as pcam
from torch_parity import port_params, sqrt_grads, sqrt_inputs, t

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def _u32_words(seed, n=20000):
    w = np.random.default_rng(seed).integers(0, 2 ** 32, size=(4, n), dtype=np.uint64)
    w[:, :4] = [[0, 2 ** 31, 2 ** 32 - 1, 2 ** 31 - 1]] * 4  # edges, incl. >= 2^31
    return w


def test_pcg4d_bit_exact():
    w = _u32_words(0)
    ref = jrng.pcg4d(*[jnp.asarray(x.astype(np.uint32)) for x in w])
    out = prng.pcg4d(*[torch.from_numpy(x.astype(np.int64)) for x in w])
    assert (w >= 2 ** 31).any()
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64), o.numpy())


def test_pcg4d_takes_negative_int32_as_u32():
    w = _u32_words(1)
    as_i32 = [torch.from_numpy(x.astype(np.uint32).view(np.int32)) for x in w]
    as_i64 = [torch.from_numpy(x.astype(np.int64)) for x in w]
    for a, b in zip(prng.pcg4d(*as_i32), prng.pcg4d(*as_i64)):
        assert torch.equal(a, b)


def test_uniform4_bit_exact():
    r = np.random.default_rng(2)
    uid = r.integers(0, 2 ** 31, 5000).astype(np.int32)
    smp = r.integers(0, 1000, 5000).astype(np.int32)
    for ctr, seed in [(0, 0), (1, 7), (4 * 19 + 2, 2 ** 32 - 5)]:
        ref = np.asarray(jrng.uniform4(jnp.asarray(uid), jnp.asarray(smp), jnp.uint32(ctr), seed))
        out = prng.uniform4(t(uid), t(smp), ctr, seed).numpy()
        assert out.dtype == np.float32
        np.testing.assert_array_equal(ref, out)


def test_to_u8_image_bit_exact():
    r = np.random.default_rng(3)
    rad = (r.normal(0.5, 0.6, (17, 23, 3)) ** 3).astype(np.float32)
    rad[0, :4, 0] = [0.0, -0.0, 0.998001, 1e6]
    ref = np.asarray(jcolor.to_u8_image(jnp.asarray(rad)))
    out = pcolor.to_u8_image(t(rad)).numpy()
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(ref, out)


def test_generate_rays_defocus_and_motion():
    """Defocus disk and STREAM_TIME motion draws; rays within 1e-6 (the
    disk's cos/sin may differ by an ulp between XLA and PyTorch)."""
    for name, kw in [("bouncing_spheres", {}), ("three_spheres", {"defocus_angle": 8.0})]:
        _, cfg = jbuild(name, image_width=32, samples_per_pixel=2, **kw)
        assert cfg.defocus_angle > 0
        pj = jcam.CameraParams.from_config(cfg)
        dj = jcam.derive(cfg, pj)
        dp = pcam.derive(cfg, port_params(pj))
        for f in ("center", "pixel00", "pixel_delta_u", "pixel_delta_v",
                  "defocus_disk_u", "defocus_disk_v"):
            np.testing.assert_allclose(getattr(dp, f).numpy(), np.asarray(getattr(dj, f)),
                                       rtol=0, atol=1e-6)
        pix = np.minimum(np.arange(2048) % 1024, cfg.n_pixels - 1).astype(np.int32)
        smp = (np.arange(2048) // 1024).astype(np.int32)
        ref = jcam.generate_rays(cfg, dj, jnp.asarray(pix), jnp.asarray(smp), jnp.uint32(5))
        out = pcam.generate_rays(cfg, dp, t(pix), t(smp), 5)
        for r_, o_ in zip(ref, out):
            np.testing.assert_allclose(o_.numpy(), np.asarray(r_), rtol=0, atol=1e-6)
        assert float(out[2].std()) > 0.1  # motion time really drawn


def test_port_imports_without_jax():
    """Neither the port nor chip_smoke.py imports JAX or the JAX package."""
    code = ("import sys, raytracing_tpu_torch, raytracing_tpu_torch.ops.megakernel, "
            "raytracing_tpu_torch.scene.convert, raytracing_tpu_torch.diff, "
            "raytracing_tpu_torch.bench; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'raytracing_tpu')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    sources = [*(REPO / "raytracing_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|raytracing_tpu)(\.|\s|$)", re.M)
    assert not [p for p in sources if imports.search(p.read_text())]


def test_sqrt_rn_card_route_has_the_float64_routes_gradient():
    """The float32 route that sqrt_rn takes on CUDA tensors (``_Sqrt32``)
    has the float64 route's gradient bit for bit, and float32
    ``torch.sqrt``'s own gradient does not (on the CPU, where both can
    run; the card holds the forward in tests/test_torch_cuda.py)."""
    from raytracing_tpu_torch.ops.intersect import _Sqrt32, sqrt_rn

    xs = sqrt_inputs("cpu", n=1 << 16)
    g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3))
    ref = sqrt_grads(lambda x: torch.sqrt(x.double()).float(), xs, g)
    assert torch.equal(sqrt_grads(_Sqrt32.apply, xs, g), ref)
    assert torch.equal(sqrt_grads(sqrt_rn, xs, g), ref)
    assert int((sqrt_grads(torch.sqrt, xs, g) != ref).sum()) > 0
