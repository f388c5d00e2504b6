"""Device ms an image of every kernel that is not one of the port's own
CUDA kernels (``csrc/*.cu``): camera rays, the RNG, compaction, gathers
and accumulation, from the profiler's trace of the window."""
from benchmark.common import profile


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "render" or tr is None or not ctx["items"]:
        return None
    secs = sum(v[0] for n, v in tr["kernels"].items()
               if profile.is_kernel(n) and profile.kernel_of(n, tr["port_kernels"]) is None)
    return 1e3 * secs / ctx["items"] if secs > 0 else None
