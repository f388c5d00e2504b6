"""Device ms an image of K1 (``k1_trace_block``), from the profiler's trace."""
from benchmark.common import readers


def read(ctx):
    return readers.kernel_ms_per_item(ctx, "render", "k1_trace_block")
