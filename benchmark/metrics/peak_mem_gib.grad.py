"""The card's peak memory in the window: ``torch.cuda.max_memory_reserved``
after ``reset_peak_memory_stats`` at the window's start, in GiB. Reserved
and not allocated memory, since the replayed programs' buffers live in
their CUDA graphs' pools, which the allocator holds as reserved."""


def read(ctx):
    if ctx["kind"] != "grad" or not ctx["peak_window_bytes"]:
        return None
    return ctx["peak_window_bytes"] / 2**30
