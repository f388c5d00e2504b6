"""K1 launches an image: the port's device launch counter
(``ops.megakernel_block.launches``), reset before the window, over the
images of the window. The renderer's schedule sets it: launches × phases."""


def read(ctx):
    if ctx["kind"] != "render" or not ctx["items"]:
        return None
    return ctx["counters"]["k1_launches"] / ctx["items"]
