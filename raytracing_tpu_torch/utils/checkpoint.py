"""Checkpoint / resume, the counterpart of ``raytracing_tpu.utils.checkpoint``:

(a) **render checkpoints**: the accumulated per-pixel radiance sums and the
    next sample-chunk cursor, so an interrupted render resumes
    mid-accumulation with an identical final image (the counter-based RNG
    makes the replay exact). The npz layout is the JAX package's, so a
    file written by either package loads in the other;
(b) **tensor checkpoints**: a flat ``{name: tensor}`` dict (parameters,
    optimizer state) as npz, in place of the JAX package's pytrees.

The renderer is restartable: rerun it with the last checkpoint and only
the missing sample chunks are traced (tests/test_torch_utils.py).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def save_render_state(path: str, state: Dict[str, Any]) -> None:
    """Atomically persist {'accum': (N,3) f32, 'segments': int, 'schunk': int}."""
    _atomic_savez(path, dict(accum=np.asarray(state["accum"], np.float32),
                             segments=np.int64(state["segments"]),
                             schunk=np.int64(state["schunk"])))


def load_render_state(path: str) -> Optional[Dict[str, Any]]:
    """The state :func:`save_render_state` wrote, or None if ``path`` does
    not exist."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {"accum": z["accum"], "segments": int(z["segments"]),
                "schunk": int(z["schunk"])}


def save_state_dict(path: str, state: Dict[str, torch.Tensor]) -> None:
    """Atomically persist a flat ``{name: tensor}`` dict as npz (host copies;
    the dtypes numpy has)."""
    _atomic_savez(path, {k: v.detach().cpu().numpy() for k, v in state.items()})


def load_state_dict(path: str, device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """The dict :func:`save_state_dict` wrote, its tensors on ``device``
    (default: the card; raises without CUDA unless ``device="cpu"``)."""
    dev = resolve(device)
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
