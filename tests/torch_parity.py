"""Shared helpers for the tests that hold ``raytracing_tpu_torch`` against
``raytracing_tpu``: data crosses between the two packages as numpy
arrays keyed by field path."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_tpu_torch.scene.convert import camera_params_from_arrays, scene_from_arrays

SCENE_GROUPS = ("spheres", "quads", "materials", "textures", "atlas", "perlin")
# XLA's CPU backend at -O0 without its expensive LLVM passes: the JAX
# references compile ~2x faster, and with few of the FMA contractions that
# jitted CPU code otherwise has (the port contracts none)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


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


def jit_run(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with FAST_COMPILE."""
    import jax

    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def t(a) -> torch.Tensor:
    """numpy or JAX array → CPU tensor (copied)."""
    return torch.from_numpy(np.array(a))


def segments_close(s_ref: int, s: int) -> bool:
    """The reference's segment tolerance: rare f32 coin flips."""
    return abs(int(s_ref) - int(s)) <= max(4, int(s_ref) // 200)


def bouncing_spheres_64(b, seed: int = 42):
    """Fill a SceneBuilder (either package's) with ``bouncing_spheres``
    widened from a 22×22 to a 64×64 grid: the same rng stream, materials
    and 3 big spheres, about 4,100 spheres. Returns ``b``."""
    ground = b.lambertian(b.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.sphere((0.0, -1000.0, -1.0), 1000.0, ground)
    rng = np.random.default_rng(seed)
    for a in range(-32, 32):
        for bb in range(-32, 32):
            choose_mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) > 0.9:
                if choose_mat < 0.8:
                    albedo = rng.random(3) * rng.random(3)
                    mat = b.lambertian(tuple(albedo))
                    center2 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
                    b.sphere(tuple(center), 0.2, mat, center2=tuple(center2))
                elif choose_mat < 0.95:
                    albedo = rng.uniform(0.5, 1.0, 3)
                    mat = b.metal(tuple(albedo), rng.uniform(0.0, 0.5))
                    b.sphere(tuple(center), 0.2, mat)
                else:
                    b.sphere(tuple(center), 0.2, b.dielectric(1.5))
    b.sphere((0.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.sphere((-4.0, 1.0, 0.0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.sphere((4.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))
    return b


def bouncing_spheres_64_config(config_cls, **overrides):
    """``bouncing_spheres``' camera (400×225, depth 20) as ``config_cls``."""
    return config_cls(**{**dict(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100, max_depth=20,
        background=(0.7, 0.8, 1.0), vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0), defocus_angle=0.6, focus_dist=10.0),
        **overrides})


def mixed_scene(b):
    """Spheres, a quad and emitters (tests/test_megakernel.py
    test_bvh_mixed_scene) in a SceneBuilder of either package."""
    ground = b.lambertian((0.6, 0.6, 0.2))
    b.sphere((0, -1000, 0), 1000.0, ground)
    for i in range(24):
        b.sphere((i % 6 * 2 - 5, 0.5, i // 6 * 2 - 3), 0.5,
                 b.lambertian((0.2 + 0.03 * i, 0.4, 0.6)))
    light = b.diffuse_light((4.0, 4.0, 4.0))
    b.quad((3, 1, -2), (2, 0, 0), (0, 2, 0), light)
    b.sphere((0, 7, 0), 2.0, light)
    return b


def mixed_scene_config(config_cls, **overrides):
    return config_cls(**{**dict(
        image_width=32, aspect_ratio=1.0, samples_per_pixel=1, max_depth=6, vfov=20.0,
        lookfrom=(26.0, 3.0, 6.0), lookat=(0.0, 2.0, 0.0), background=(0.0, 0.0, 0.0)),
        **overrides})
