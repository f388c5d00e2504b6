"""Multi-process renders in sample windows, with a checkpoint after each,
the counterpart of ``raytracing_tpu/parallel/multihost.py:38-142``.

In the JAX package a multi-host render needs global arrays over every
process's devices; here every mesh position is already a process, so
:func:`global_mesh` is :func:`make_mesh` over all ranks of the initialized
process group (``initialize_distributed``: one host or many) and the
sharded renderer (``shard.py``) returns the whole image on every rank.
What this module adds is the recovery unit: sample windows summed on the
host, a checkpoint that rank 0 writes atomically after each window, and
resume from it. RNG ids are global, so a resumed render equals the
uninterrupted one bit for bit.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE
from ..render.camera import CameraConfig, CameraParams
from ..scene.types import Scene
from .mesh import Mesh, barrier, make_mesh
from .shard import build_sharded_renderer


def global_mesh(axis_sizes, axis_names, device=DEFAULT_DEVICE) -> Mesh:
    """A mesh over every rank of the process group (all hosts)."""
    return make_mesh(axis_sizes, axis_names, device)


def render_sharded_distributed(scene: Scene, cfg: CameraConfig, mesh: Mesh,
                               params: Optional[CameraParams] = None, seed: int = 0, *,
                               hit_method: str = "brute", sample_chunk: Optional[int] = None,
                               checkpoint: Optional[str] = None, chunk_cb=None):
    """A sharded render → ((H, W, 3) mean radiance, total segments) on every
    rank.

    ``sample_chunk``: render the samples in windows of this many samples
    per pixel, summed on the host. After each window rank 0 writes
    ``checkpoint`` (npz: the sample sum so far, segments, the next window)
    through a temporary file and ``os.replace``; then every rank waits for
    every other (a barrier), so window k's checkpoint is on disk before
    any rank's ``chunk_cb(k)`` runs (a fault injected there cannot
    outrun it). If ``checkpoint`` exists on entry every rank resumes from
    its window (the file must be readable by every rank: a shared
    filesystem). A rank that dies mid-window stalls the others in their
    next collective, which raises after ``mesh.TIMEOUT``; the job is
    relaunched and replays only the remaining windows."""
    fn, scene_prep, n_pix_pad = build_sharded_renderer(scene, cfg, mesh, hit_method=hit_method)
    if params is None:
        params = CameraParams.from_config(cfg, mesh.device)
    spp = cfg.samples_per_pixel
    step = spp if sample_chunk is None else sample_chunk
    windows = [(s, min(s + step, spp)) for s in range(0, spp, step)]

    acc = np.zeros((n_pix_pad, 3), np.float32)
    seg_total, start_k = 0, 0
    if checkpoint and os.path.exists(checkpoint):
        with np.load(checkpoint) as ck:
            acc = ck["acc"]
            seg_total = int(ck["segments"])
            start_k = int(ck["next_window"])
    for k in range(start_k, len(windows)):
        with torch.no_grad():
            part, segments = fn(scene_prep, params, seed, windows[k])
        acc = acc + part.cpu().numpy()
        seg_total += segments
        if checkpoint:
            if mesh.rank == 0:
                tmp = checkpoint + ".tmp.npz"  # np.savez appends .npz itself
                np.savez(tmp, acc=acc, segments=seg_total, next_window=k + 1)
                os.replace(tmp, checkpoint)
            barrier(mesh)
        if chunk_cb is not None:
            chunk_cb(k)
    mean = acc[:cfg.n_pixels] / spp
    return mean.reshape(cfg.image_height, cfg.image_width, 3), seg_total
