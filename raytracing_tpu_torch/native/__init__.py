"""Native (C++) runtime components: BVH builder + image serialization.
See rt_native.py for the ctypes binding with automatic NumPy fallback."""
