"""Share of a render cell's traced window in which nothing ran on the card."""
from benchmark.common import readers


def read(ctx):
    return readers.idle_pct(ctx, "render")
