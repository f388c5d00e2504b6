"""Camera samples (pixels × spp) of every gradient sweep completed in the
window, over the seconds from the window's start to the last sweep's end."""
from benchmark.common import readers


def read(ctx):
    return readers.samples_per_s(ctx, "grad")
