"""PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT
2020) in plain PyTorch, keyed as the renderer keys its draws.

Every draw is a pure function of (pixel, sample, counter, seed), the
counter being ``bounce * 4 + stream``: stream 0 is the camera's pixel
jitter (x, y) and defocus disk (z, w), stream 1 the ray's time (x),
stream 2 a bounce's scatter direction (x, y) and Fresnel coin (z).

u32 words are held in int64 and masked after every operation; a product
of two words is split into 16-bit halves so that no intermediate leaves
the int64 range.
"""
from __future__ import annotations

import torch

STREAM_RAYGEN = 0
STREAM_TIME = 1
STREAM_SCATTER = 2
N_STREAMS = 4

_M = 0xFFFFFFFF


def _mul(a, b):
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M


def pcg4d(a, b, c, d):
    """Four int tensors (any values: taken mod 2**32) → four u32 words in int64."""
    v = [(x.to(torch.int64) & _M) * 1664525 + 1013904223 for x in (a, b, c, d)]
    v = [x & _M for x in v]
    for _ in range(2):
        v[0] = (v[0] + _mul(v[1], v[3])) & _M
        v[1] = (v[1] + _mul(v[2], v[0])) & _M
        v[2] = (v[2] + _mul(v[0], v[1])) & _M
        v[3] = (v[3] + _mul(v[1], v[2])) & _M
        if _ == 0:
            v = [x ^ (x >> 16) for x in v]
    return v


def uniforms(pix, smp, ctr: int, seed: int, dtype=torch.float32):
    """Four U[0, 1) draws per ray, ``(n, 4)``: the top 24 bits of each word."""
    c = torch.full_like(pix, ctr, dtype=torch.int64)
    s = torch.full_like(pix, seed & _M, dtype=torch.int64)
    words = pcg4d(pix, smp, c, s)
    return torch.stack([(w >> 8).to(torch.float32) * (1.0 / (1 << 24)) for w in words],
                       dim=-1).to(dtype)
