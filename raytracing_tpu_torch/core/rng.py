"""Counter-based, stateless RNG: the PCG4D hash (Jarzynski & Olano,
"Hash Functions for GPU Rendering", JCGT 2020), bit-exact with
``raytracing_tpu.core.rng``.

Every draw is a pure function of (pixel, sample, bounce * N_STREAMS +
stream, seed), so renders are reproducible and independent of how rays
are batched. No ``torch.Generator`` is involved.

The hash is u32 arithmetic. PyTorch's CPU backend cannot add ``uint32``
tensors, so the words are held in ``int64`` in [0, 2^32) and masked after
every multiply and add; a product of two u32 words is split in 16-bit
halves so no intermediate leaves the int64 range. ``>> 16`` then acts on
a non-negative value, as a logical shift does. The CUDA kernel
(csrc/megakernel_block.cu) computes the same hash in native ``uint32_t``.
"""
from __future__ import annotations

import math

import torch

# Per-bounce random streams (which of the 4 outputs each sampler reads is
# fixed by the samplers below and by the megakernel's scatter).
STREAM_RAYGEN = 0    # pixel jitter (x, y), defocus disk (z, w)
STREAM_TIME = 1      # motion-blur ray time
STREAM_SCATTER = 2   # scatter direction (x, y), Fresnel coin (z)
STREAM_MEDIUM = 3    # lane k: medium k's free path (scene/builder.py MAX_MEDIA = 4)
N_STREAMS = 4

_MASK = 0xFFFFFFFF
_MUL = 1664525
_ADD = 1013904223
_INV_2_24 = 1.0 / (1 << 24)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor → its u32 value held in int64."""
    return x.to(torch.int64) & _MASK


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a · b) mod 2^32 for u32 words in int64, without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def pcg4d(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor):
    """PCG4D hash: four u32 lanes in, four decorrelated u32 lanes out.

    Inputs are integer tensors (negative values wrap as u32); outputs are
    int64 tensors holding u32 values."""
    v0, v1, v2, v3 = _u32(a), _u32(b), _u32(c), _u32(d)
    v0 = (v0 * _MUL + _ADD) & _MASK
    v1 = (v1 * _MUL + _ADD) & _MASK
    v2 = (v2 * _MUL + _ADD) & _MASK
    v3 = (v3 * _MUL + _ADD) & _MASK
    v0 = (v0 + _mul(v1, v3)) & _MASK
    v1 = (v1 + _mul(v2, v0)) & _MASK
    v2 = (v2 + _mul(v0, v1)) & _MASK
    v3 = (v3 + _mul(v1, v2)) & _MASK
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = (v0 + _mul(v1, v3)) & _MASK
    v1 = (v1 + _mul(v2, v0)) & _MASK
    v2 = (v2 + _mul(v0, v1)) & _MASK
    v3 = (v3 + _mul(v1, v2)) & _MASK
    return v0, v1, v2, v3


def to_unit_float(u: torch.Tensor) -> torch.Tensor:
    """u32 → f32 uniform in [0, 1) from the top 24 bits (exact in f32)."""
    return (u >> 8).to(torch.float32) * _INV_2_24


def _lanes(x, uid: torch.Tensor) -> torch.Tensor:
    """``x`` (a tensor or a Python int) as int64 lanes of ``uid``'s shape.
    An int is filled on the device rather than copied from the host, so
    ray generation can run inside a captured CUDA graph."""
    if isinstance(x, torch.Tensor):
        x = x.to(device=uid.device, dtype=torch.int64)
    else:
        x = torch.full((), int(x), dtype=torch.int64, device=uid.device)
    return x.expand(uid.shape)


def uniform4(uid: torch.Tensor, sample: torch.Tensor, ctr, seed) -> torch.Tensor:
    """Four independent U[0,1) floats per element; shape ``uid.shape + (4,)``.

    ``uid``: per-ray id (pixel index). ``sample``: sample index. ``ctr``:
    bounce * N_STREAMS + stream (tensor or int). ``seed``: render seed."""
    v = pcg4d(uid, sample, _lanes(ctr, uid), _lanes(seed, uid))
    return torch.stack([to_unit_float(x) for x in v], dim=-1)


def square_offset(u: torch.Tensor) -> torch.Tensor:
    """AA jitter in [-0.5, 0.5)^2 from ``u[..., :2]``. Returns (..., 2)."""
    return u[..., :2] - 0.5


def unit_disk(u: torch.Tensor) -> torch.Tensor:
    """Uniform point on the unit disk via sqrt(r)·(cos, sin). Returns (..., 2)."""
    r = torch.sqrt(u[..., 0])
    theta = (2.0 * math.pi) * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def unit_vector(u: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere via z = 1 - 2u, φ = 2πv from
    ``u[..., :2]``. Returns (..., 3)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
