"""Color pipeline: linear radiance → gamma-corrected 8-bit, the same
arithmetic as ``raytracing_tpu.core.color`` (γ = 2 by sqrt, clamp to
[0, 0.999], ×256, truncate). The sqrt is correctly rounded, as XLA's and
CUDA's are: on the CPU it goes through float64 (PyTorch's vectorized CPU
float32 sqrt is off by an ulp on some inputs, which can move a pixel's
level)."""
from __future__ import annotations

import torch


def to_u8_image(radiance: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) mean radiance → (H, W, 3) u8 image, on the same device."""
    g = torch.clamp(radiance, min=0.0)
    g = torch.sqrt(g) if g.is_cuda else torch.sqrt(g.double()).float()
    g = torch.clamp(g, 0.0, 0.999)
    return (256.0 * g).to(torch.uint8)
