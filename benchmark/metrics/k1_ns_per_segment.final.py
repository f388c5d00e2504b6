"""Device ns of K1 (``k1_trace_block``) a segment of the traced images:
K1's time in the profiler's trace over the images' segments, which media
lengthen, so K1 is judged per unit of work."""
from benchmark.common import profile


def read(ctx):
    tr = ctx["trace"]
    segments = sum(ctx["work"].get("segments_per_item", []))
    if ctx["kind"] != "render" or tr is None or not segments:
        return None
    secs = profile.seconds_of(tr["kernels"], "k1_trace_block")
    return 1e9 * secs / segments if secs > 0 else None
