"""Utilities: checkpoints, image output, logging, profiling and sanitizers."""
