"""The modules a run may not load: JAX and the JAX package, compared by
each module's whole top-level name (the part before the first dot), so
that ``raytracing_tpu_torch`` is not taken for ``raytracing_tpu``."""
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracing_tpu")


def forbidden(module_names) -> list:
    """The names among ``module_names`` whose top-level name is forbidden."""
    return sorted(n for n in module_names if n.split(".", 1)[0] in FORBIDDEN)
