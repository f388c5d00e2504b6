"""The device the port's entry points build on: the card unless the caller
names another. There is no silent fallback: asking for the card where
CUDA is unavailable raises, and the CPU runs only when it is asked for
(``device="cpu"``)."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`; raises for a CUDA device
    when CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the port's default is the card) but CUDA is "
            "unavailable; pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
