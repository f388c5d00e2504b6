"""Camera samples (pixels × spp) of every image completed in the window,
over the seconds from the window's start to the last image's end."""
from benchmark.common import readers


def read(ctx):
    return readers.samples_per_s(ctx, "render")
