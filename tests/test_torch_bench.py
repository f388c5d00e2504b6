"""The port's fwd+bwd bench chunk against the JAX package's: one
``grads_chunk`` of ``_fwd_bwd_setup`` at width 32, spp 2, depth 2, phases
[1,1] on both sides (the JAX side runs its Pallas kernels in interpret
mode, as its own tests do, which costs ~10 s per bounce and per phase, so
the chunk is the shortest that still runs a second, compacted phase; the
port runs with its planned prefixes).

Bars. Each package runs its own decision pass here, and the two trace
different paths on a few rays: XLA on the CPU contracts multiply-adds
into FMAs and the port does not, and a grazing hit turns the last-bit
difference into another path (a few rays of 2048 at depth 6; on
cornell_box one of them is an emitter hit). A flipped ray changes its pixel's MSE
cotangent. At this depth no ray of the chunk flips (measured: loss
1.5e-7 relative, rgb gradient 6.3e-7 relative L2; at depth 6 the flips
gave 1.4e-5 and 3.3e-3), so the chunk is held at: segments within
max(4, s/200), loss at rtol 1e-5, the rgb gradient at a relative L2 error
below 1e-5; the center gradient is zero in both (with
the decisions fixed, throughput is a product of albedos under a constant
sky). The reference's own bars (rtol 3e-5, atol 3e-6) hold on identical
inputs in tests/test_torch_replay.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from raytracing_tpu_torch import bench as pbench
from torch_parity import segments_close

torch.set_num_threads(2)
SMALL = dict(width=32, spp=2, max_depth=2, seed=7, spp_chunk=2, phases=[1, 1])


def test_grads_chunk_matches_jax():
    js = jbench._fwd_bwd_setup(**SMALL)
    ps = pbench._fwd_bwd_setup(**SMALL, device="cpu")
    assert ps["B"] == js["B"] == 2048
    prefixes = ps["plan"]()
    assert min(prefixes) < ps["B"] and ps["ns"]["decide_prefixes"][0] is None
    j = jax.jit(js["grads_chunk"])(*js["args"], jnp.int32(0))  # jitted: cheaper to interpret
    p = ps["grads_chunk"](*ps["args"], 0)
    assert bool(j[3]) and bool(p[3])
    assert segments_close(int(j[4]), int(p[4])), (int(j[4]), int(p[4]))
    np.testing.assert_allclose(float(p[0]), float(j[0]), rtol=1e-5)
    assert float(np.abs(np.asarray(j[1])).max()) == 0.0 and float(p[1].abs().max()) == 0.0
    gj, gp = np.asarray(j[2]), p[2].numpy()
    assert np.linalg.norm(gj) > 0
    assert np.linalg.norm(gp - gj) / np.linalg.norm(gj) < 1e-5


def test_bench_needs_the_card():
    """The bench measures the card: without CUDA its default raises."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the check is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        pbench.bench_fwd_bwd(width=32, spp=2, max_depth=6)
