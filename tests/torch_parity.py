"""Shared helpers for the tests that hold ``raytracing_tpu_torch`` against
``raytracing_tpu``: data crosses between the two packages as numpy
arrays keyed by field path."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_tpu_torch.scene.convert import camera_params_from_arrays, scene_from_arrays

SCENE_GROUPS = ("spheres", "quads", "materials", "textures", "atlas")


def scene_arrays(scene) -> dict:
    """A JAX ``Scene`` → ``{"spheres.center": np.ndarray, ...}``."""
    out = {}
    for group in SCENE_GROUPS:
        part = getattr(scene, group)
        for f in dataclasses.fields(part):
            out[f"{group}.{f.name}"] = np.asarray(getattr(part, f.name))
    return out


def port_scene(scene_jax):
    """The JAX scene's arrays as a port ``Scene`` on the CPU."""
    return scene_from_arrays(scene_arrays(scene_jax), device="cpu",
                             image_bilinear=scene_jax.flags.image_bilinear)


def port_params(params_jax):
    """JAX ``CameraParams`` → port ``CameraParams`` on the CPU."""
    return camera_params_from_arrays(
        {f.name: np.asarray(getattr(params_jax, f.name))
         for f in dataclasses.fields(params_jax)}, device="cpu")


def t(a) -> torch.Tensor:
    """numpy or JAX array → CPU tensor (copied)."""
    return torch.from_numpy(np.array(a))


def segments_close(s_ref: int, s: int) -> bool:
    """The reference's segment tolerance: rare f32 coin flips."""
    return abs(int(s_ref) - int(s)) <= max(4, int(s_ref) // 200)
