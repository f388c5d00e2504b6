"""The benchmark of raytracing_tpu_torch (see run.py)."""
