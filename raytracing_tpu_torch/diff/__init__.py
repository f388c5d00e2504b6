"""Differentiable rendering by decision replay: the packed replay table
and the replay kernels (K3 forward, K2 backward), the counterparts of
``raytracing_tpu.diff.replay_fast`` and ``raytracing_tpu.diff.replay_kernel``."""
from .replay_fast import N_FIELDS, build_replay_table, supported_fast
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
