"""The benchmark's frozen arithmetic: the import guard, the comparison
that decides ``correct``, the profiler's reductions and the byte counts
and peaks of the port's kernels."""
