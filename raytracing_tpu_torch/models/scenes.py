"""The scene registry: the counterpart of ``raytracing_tpu.models.scenes``,
all nine scenes, and The Next Week's final scene (``next_week_final``),
which the JAX package does not have: its participating media render
through K1 alone. The constants are the JAX package's, ``bouncing_spheres``
draws from the same ``np.random.default_rng(seed)`` stream, the Perlin
tables from the same seed and ``earth`` loads the same image, so both
packages build identical tables; the integrator's BVH is built where the
JAX package builds it by default (``use_bvh``: ``bouncing_spheres`` only).
Every scene renders through the megakernels (K1, K5) and the wavefront
integrator alike: ``perlin_sphere`` and ``simple_light`` shade marble
noise, ``earth`` an image.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict, Tuple

import numpy as np

from ..core.device import DEFAULT_DEVICE
from ..render.camera import CameraConfig
from ..scene import assets
from ..scene.builder import SceneBuilder
from ..scene.types import Scene

SceneFn = Callable[..., Tuple[Scene, CameraConfig]]
SCENES: Dict[str, SceneFn] = {}

SKY = (0.7, 0.8, 1.0)


def register(name: str):
    def deco(fn: SceneFn):
        SCENES[name] = fn
        return fn

    return deco


def build(name: str, device=DEFAULT_DEVICE, **kwargs) -> Tuple[Scene, CameraConfig]:
    """Build a registry scene by name on ``device`` (default: the card;
    ``device="cpu"`` for the CPU); keyword arguments override the scene's
    own (``seed``) or its CameraConfig fields."""
    if name not in SCENES:
        raise KeyError(f"unknown scene '{name}'; available: {sorted(SCENES)}")
    return SCENES[name](device=device, **kwargs)


def _cfg(cfg: CameraConfig, overrides: dict) -> CameraConfig:
    return replace(cfg, **overrides) if overrides else cfg


@register("bouncing_spheres")
def bouncing_spheres(device=DEFAULT_DEVICE, seed: int = 42, use_bvh: bool = True,
                     **cam_overrides):
    """Checker ground + 22×22 seeded grid of small spheres (80% moving
    lambertian / 15% metal / 5% glass) + 3 big spheres."""
    b = SceneBuilder()
    ground = b.lambertian(b.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.sphere((0.0, -1000.0, -1.0), 1000.0, ground)

    rng = np.random.default_rng(seed)
    for a in range(-11, 11):
        for bb in range(-11, 11):
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

    cfg = CameraConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=50,
        max_depth=20, background=SKY, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0), defocus_angle=0.6,
        focus_dist=10.0,
    )
    return b.compile(device, use_bvh=use_bvh), _cfg(cfg, cam_overrides)


@register("checkered_spheres")
def checkered_spheres(device=DEFAULT_DEVICE, use_bvh: bool = False, **cam_overrides):
    """Two r=10 checkered spheres."""
    b = SceneBuilder()
    mat = b.lambertian(b.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.sphere((0.0, -10.0, 0.0), 10.0, mat)
    b.sphere((0.0, 10.0, 0.0), 10.0, mat)
    cfg = CameraConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=50,
        max_depth=20, background=SKY, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0), defocus_angle=0.0,
    )
    return b.compile(device, use_bvh=use_bvh), _cfg(cfg, cam_overrides)


@register("quads")
def quads(device=DEFAULT_DEVICE, use_bvh: bool = False, **cam_overrides):
    """Five colored quads."""
    b = SceneBuilder()
    b.quad((-3, -2, 5), (0, 0, -4), (0, 4, 0), b.lambertian((1.0, 0.2, 0.2)))
    b.quad((-2, -2, 0), (4, 0, 0), (0, 4, 0), b.lambertian((0.2, 1.0, 0.2)))
    b.quad((3, -2, 1), (0, 0, 4), (0, 4, 0), b.lambertian((0.2, 0.2, 1.0)))
    b.quad((-2, 3, 1), (4, 0, 0), (0, 0, 4), b.lambertian((1.0, 0.5, 0.0)))
    b.quad((-2, -3, 5), (4, 0, 0), (0, 0, -4), b.lambertian((0.2, 0.8, 0.8)))
    cfg = CameraConfig(
        aspect_ratio=1.0, image_width=400, samples_per_pixel=100,
        max_depth=50, background=SKY, vfov=80.0, lookfrom=(0.0, 0.0, 9.0),
        lookat=(0.0, 0.0, 0.0), defocus_angle=0.0,
    )
    return b.compile(device, use_bvh=use_bvh), _cfg(cfg, cam_overrides)


def _earth_texture(b: SceneBuilder, image: str) -> int:
    """The first found of ``image`` (the reference's asset, for exact
    parity with it), the repository's ``images/earthmap.ppm`` (a
    procedurally generated stand-in) and the in-memory generator."""
    if assets.find_image(image) is not None:
        return b.image(image)
    if assets.find_image("earthmap.ppm") is not None:
        return b.image("earthmap.ppm")
    return b.image(assets.generate_earthlike())


@register("earth")
def earth(device=DEFAULT_DEVICE, use_bvh: bool = False, image: str = "earthmap.jpg",
          **cam_overrides):
    """An image-textured globe. The image is the first found of ``image``,
    ``images/earthmap.ppm`` and the in-memory generator, as in the JAX
    package."""
    b = SceneBuilder()
    b.sphere((0.0, 0.0, 0.0), 2.0, b.lambertian(_earth_texture(b, image)))
    cfg = CameraConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100,
        max_depth=50, background=SKY, vfov=20.0, lookfrom=(0.0, 0.0, 12.0),
        lookat=(0.0, 0.0, 0.0), defocus_angle=0.0,
    )
    return b.compile(device, use_bvh=use_bvh), _cfg(cfg, cam_overrides)


@register("perlin_sphere")
def perlin_sphere(device=DEFAULT_DEVICE, use_bvh: bool = False, **cam_overrides):
    """Marble-noise ground and sphere."""
    b = SceneBuilder()
    pertext = b.noise(4.0)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(pertext))
    b.sphere((0.0, 2.0, 0.0), 2.0, b.lambertian(pertext))
    cfg = CameraConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100,
        max_depth=50, background=SKY, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0), defocus_angle=0.0,
    )
    return b.compile(device, use_bvh=use_bvh), _cfg(cfg, cam_overrides)


@register("simple_light")
def simple_light(device=DEFAULT_DEVICE, use_bvh: bool = False, **cam_overrides):
    """Marble spheres lit by an emissive sphere and quad, black background."""
    b = SceneBuilder()
    pertext = b.noise(4.0)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(pertext))
    b.sphere((0.0, 2.0, 0.0), 2.0, b.lambertian(pertext))
    difflight = b.diffuse_light((4.0, 4.0, 4.0))
    b.sphere((0.0, 7.0, 0.0), 2.0, difflight)
    b.quad((3.0, 1.0, -2.0), (2.0, 0.0, 0.0), (0.0, 2.0, 0.0), difflight)
    cfg = CameraConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100,
        max_depth=50, background=(0.0, 0.0, 0.0), vfov=20.0,
        lookfrom=(26.0, 3.0, 6.0), lookat=(0.0, 2.0, 0.0), defocus_angle=0.0,
    )
    return b.compile(device, use_bvh=use_bvh), _cfg(cfg, cam_overrides)


@register("cornell_box")
def cornell_box(device=DEFAULT_DEVICE, use_bvh: bool = False, **cam_overrides):
    """Cornell box with two unrotated blocks."""
    b = SceneBuilder()
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((15.0, 15.0, 15.0))
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green)
    b.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    b.quad((343, 554, 332), (-130, 0, 0), (0, 0, -105), light)
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    b.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    b.quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white)
    b.box((130, 0, 65), (295, 165, 230), white)
    b.box((265, 0, 295), (430, 330, 460), white)
    cfg = CameraConfig(
        aspect_ratio=1.0, image_width=600, samples_per_pixel=100,
        max_depth=50, background=(0.0, 0.0, 0.0), vfov=40.0,
        lookfrom=(278.0, 278.0, -800.0), lookat=(278.0, 278.0, 0.0),
        defocus_angle=0.0,
    )
    return b.compile(device, use_bvh=use_bvh), _cfg(cfg, cam_overrides)


@register("single_sphere")
def single_sphere(device=DEFAULT_DEVICE, use_bvh: bool = False, **cam_overrides):
    """Single lambertian sphere on a ground sphere, 200×100 @ 16 spp,
    depth 8."""
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian((0.5, 0.5, 0.5)))
    b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    cfg = CameraConfig(
        aspect_ratio=2.0, image_width=200, samples_per_pixel=16, max_depth=8,
        background=SKY, vfov=90.0, lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0), defocus_angle=0.0, focus_dist=1.0,
    )
    return b.compile(device, use_bvh=use_bvh), _cfg(cfg, cam_overrides)


@register("three_spheres")
def three_spheres(device=DEFAULT_DEVICE, use_bvh: bool = False, **cam_overrides):
    """Lambertian / metal / dielectric trio, 400×225 @ 64 spp, depth 16."""
    b = SceneBuilder()
    b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.8, 0.8, 0.0)))
    b.sphere((0.0, 0.0, -1.2), 0.5, b.lambertian((0.1, 0.2, 0.5)))
    b.sphere((-1.0, 0.0, -1.0), 0.5, b.dielectric(1.5))
    b.sphere((1.0, 0.0, -1.0), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    cfg = CameraConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=64,
        max_depth=16, background=SKY, vfov=90.0, lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0), defocus_angle=0.0, focus_dist=1.0,
    )
    return b.compile(device, use_bvh=use_bvh), _cfg(cfg, cam_overrides)


@register("next_week_final")
def next_week_final(device=DEFAULT_DEVICE, seed: int = 42, use_bvh: bool = False,
                    image: str = "earthmap.jpg", media: bool = True, **cam_overrides):
    """The Next Week's final scene (§10, ``final_scene(800, 10000, 40)``):
    20×20 ground boxes of seeded random height (2,400 quads), a light
    quad, a moving sphere, glass and fuzzy-metal spheres, a glass sphere
    filled with a blue medium, a thin fog around everything, an earth
    (``image``, as in ``earth``), a marble sphere and a cluster of 1,000
    white spheres, 1,006 spheres and 2,401 quads in all. Box heights, then
    the cluster's centres, draw from ``np.random.default_rng(seed)``. The
    book turns the cluster by ``rotate_y(15)`` about its own origin before
    the translate and rotates each ray instead; a sphere is unchanged by a
    rotation about its centre, so here the turn and the translate are
    baked into the centres. ``media=False`` leaves the two media out
    (the scene without them, to time what they cost). The BVH is off by
    default: the integrator, its only user, refuses media."""
    b = SceneBuilder()
    rng = np.random.default_rng(seed)
    ground = b.lambertian((0.48, 0.83, 0.53))
    w = 100.0
    for i in range(20):
        for j in range(20):
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            b.box((x0, 0.0, z0), (x0 + w, rng.uniform(1.0, 101.0), z0 + w), ground)
    light = b.diffuse_light((7.0, 7.0, 7.0))
    b.quad((123.0, 554.0, 147.0), (300.0, 0.0, 0.0), (0.0, 0.0, 265.0), light)
    center1 = np.array([400.0, 400.0, 200.0])
    b.sphere(tuple(center1), 50.0, b.lambertian((0.7, 0.3, 0.1)),
             center2=tuple(center1 + np.array([30.0, 0.0, 0.0])))
    b.sphere((260.0, 150.0, 45.0), 50.0, b.dielectric(1.5))
    b.sphere((0.0, 150.0, 145.0), 50.0, b.metal((0.8, 0.8, 0.9), 1.0))
    b.sphere((360.0, 150.0, 145.0), 70.0, b.dielectric(1.5))
    if media:
        b.constant_medium((360.0, 150.0, 145.0), 70.0, 0.2, (0.2, 0.4, 0.9))
        b.constant_medium((0.0, 0.0, 0.0), 5000.0, 1e-4, (1.0, 1.0, 1.0))
    b.sphere((400.0, 200.0, 400.0), 100.0, b.lambertian(_earth_texture(b, image)))
    b.sphere((220.0, 280.0, 300.0), 80.0, b.lambertian(b.noise(0.2)))
    white = b.lambertian((0.73, 0.73, 0.73))
    th = np.radians(15.0)
    cos_t, sin_t = np.cos(th), np.sin(th)
    for _ in range(1000):
        x, y, z = rng.uniform(0.0, 165.0, 3)
        b.sphere((cos_t * x + sin_t * z - 100.0, y + 270.0, -sin_t * x + cos_t * z + 395.0),
                 10.0, white)
    cfg = CameraConfig(
        aspect_ratio=1.0, image_width=800, samples_per_pixel=10000, max_depth=40,
        background=(0.0, 0.0, 0.0), vfov=40.0, lookfrom=(478.0, 278.0, -600.0),
        lookat=(278.0, 278.0, 0.0), vup=(0.0, 1.0, 0.0), defocus_angle=0.0,
    )
    return b.compile(device, use_bvh=use_bvh), _cfg(cfg, cam_overrides)
