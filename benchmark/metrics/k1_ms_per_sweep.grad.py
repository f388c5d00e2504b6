"""Device ms a sweep of K1 (``k1_trace_block``) in the decision pass and
the planning of phases, from the profiler's trace."""
from benchmark.common import readers


def read(ctx):
    return readers.kernel_ms_per_item(ctx, "grad", "k1_trace_block")
