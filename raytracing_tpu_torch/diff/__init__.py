"""Differentiable rendering: gradients of image losses with respect to
scene and camera parameters, the counterpart of ``raytracing_tpu.diff``.

Three replay tiers, newest first:

* ``replay_kernel``: K3 forward and K2 backward (CUDA) over rays sorted by
  recorded length, with the table fold (a kernel on the card); the fwd+bwd
  bench's path (``replay_grads_sorted``) and ``replay_trace_kernel``;
* ``replay_fast``: the packed table (``build_replay_table``, which the
  kernel tier reuses) and ``replay_trace_fast``, pure PyTorch with one K4
  table lookup per bounce; differentiable to the camera too;
* ``replay``: the full-recompute replay sharing the integrator's bounce
  body, the simplest and the oracle of the other two.

``gradients`` renders through the wavefront integrator with autograd
(``render_once``, ``scene_grad``, ``camera_grad``) and ``optimize`` fits
scene parameters with ``torch.optim.Adam``.
"""
from .gradients import camera_grad, mse_loss, render_once, scene_grad
from .replay import record_decisions, render_replay, render_replay_fast, replay_trace
from .replay_fast import N_FIELDS, build_replay_table, replay_trace_fast, supported_fast
from .replay_kernel import (
    NG,
    plan_prefixes,
    reduce_table_grads,
    replay_bwd,
    replay_bwd_torch,
    replay_fwd,
    replay_fwd_torch,
    replay_grads_sorted,
    replay_trace_kernel,
)

__all__ = [
    "camera_grad",
    "mse_loss",
    "render_once",
    "scene_grad",
    "record_decisions",
    "render_replay",
    "render_replay_fast",
    "replay_trace",
    "replay_trace_fast",
    "N_FIELDS",
    "NG",
    "build_replay_table",
    "plan_prefixes",
    "reduce_table_grads",
    "replay_bwd",
    "replay_bwd_torch",
    "replay_fwd",
    "replay_fwd_torch",
    "replay_grads_sorted",
    "replay_trace_kernel",
    "supported_fast",
]
