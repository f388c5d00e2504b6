"""Set-up: from the process's start to the first timed item (imports,
the scene, the kernels' build or load, the warm-up item with its
programs' capture, and for sweeps the planning sweep)."""


def read(ctx):
    return ctx["setup_s"]
