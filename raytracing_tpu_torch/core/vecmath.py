"""Vector-math constants shared with ``raytracing_tpu.core.vecmath``."""

# a scatter direction with every component below this is degenerate
# (vecmath.near_zero; the lambertian scatter then falls back to the normal)
NEAR_ZERO_EPS = 1e-8
