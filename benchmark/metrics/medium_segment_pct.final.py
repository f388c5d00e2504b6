"""Share of the traced images' segments that a participating medium won:
K1's device counter of medium scatters (``ops.megakernel_block.
medium_scatters``, reset before the window) over the images' segments.
It describes the cell's light transport, not its speed: a change that
moves it traces other paths."""


def read(ctx):
    scatters = ctx["counters"].get("medium_scatters")
    segments = sum(ctx["work"].get("segments_per_item", []))
    if ctx["kind"] != "render" or scatters is None or not segments:
        return None
    return 100.0 * scatters / segments
