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
    """A JAX ``Scene`` → ``{"spheres.center": np.ndarray, ...}``, with the
    integrator's BVH (``bvh.*``) when the scene has one."""
    out = {}
    for group in SCENE_GROUPS + (("bvh",) if scene.bvh is not None else ()):
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


def deep_scene(b):
    """A scene whose rays run past 64 bounces, in a SceneBuilder of either
    package: the camera inside a large fuzz-0 metal sphere, so every ray
    reflects and stays alive until it meets the small light; a lambertian
    sphere inside scatters some of them. Returns ``b``."""
    b.sphere((0.0, 0.0, 0.0), 10.0, b.metal((0.95, 0.9, 0.85), 0.0))
    b.sphere((2.0, -1.5, -1.0), 1.5, b.lambertian((0.7, 0.5, 0.3)))
    b.sphere((-3.0, 2.0, 1.0), 0.6, b.diffuse_light((6.0, 6.0, 6.0)))
    return b


def deep_scene_config(config_cls, **overrides):
    """:func:`deep_scene`'s camera (32×32, depth 72) as ``config_cls``."""
    return config_cls(**{**dict(
        image_width=32, aspect_ratio=1.0, samples_per_pixel=1, max_depth=72, vfov=70.0,
        lookfrom=(0.0, 0.0, 6.0), lookat=(0.0, 0.0, 0.0), background=(0.0, 0.0, 0.0)),
        **overrides})


def sqrt_inputs(device, n: int = 1 << 24, seed: int = 11) -> torch.Tensor:
    """float32 inputs of a square root: ``n`` random bit patterns of the
    non-negative finite floats (every exponent, denormals included), then
    0, the smallest denormal and normal, the largest float, 1 - ulp and
    every power of two."""
    g = torch.Generator(device).manual_seed(seed)
    bits = torch.randint(0, 0x7F800000, (n,), generator=g, device=device, dtype=torch.int32)
    edges = torch.tensor([0, 1, 0x00800000, 0x7F7FFFFF, 0x3F7FFFFF], dtype=torch.int32,
                         device=device)
    pow2 = torch.ldexp(torch.ones(277, device=device),
                       torch.arange(-149, 128, device=device, dtype=torch.float32))
    return torch.cat([bits.view(torch.float32), edges.view(torch.float32), pow2])


def sqrt_grads(fn, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``(fn(x) * g).sum()`` in ``x``, as int32 bit
    patterns (so NaNs compare too)."""
    x = x.detach().clone().requires_grad_()
    fn(x).backward(g)
    return x.grad.view(torch.int32)


K5_EDGE_CASES = ("tangent", "negative_disc", "short_chunk", "equal_roots")


def k5_edge_case(case: str, device="cpu"):
    """A port scene and its K5 ray state ``(mega, ray_f, ray_i)`` at an edge
    of K5's member test:

    * ``tangent``: rays tangent to the unit sphere at the origin, each with
      a discriminant of exactly 0 (o = (-5, ±1, 0) or (-5, 0, ±1), d along
      x at three lengths), beside rays through it and past it;
    * ``negative_disc``: rays that pass the same sphere, every
      discriminant negative, and rays pointing away;
    * ``short_chunk``: 13 spheres in a row, so the BVH's leaves are short
      and hold pad slots, with rays from above;
    * ``equal_roots``: 16 spheres in two leaves, mirrored across z = 0,
      and rays in that plane that meet the two innermost at equal roots."""
    from raytracing_tpu_torch.ops.megakernel import build_mega_scene, pack_rays
    from raytracing_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    mat = b.metal((0.8, 0.7, 0.6), 0.0)
    rng = np.random.default_rng(K5_EDGE_CASES.index(case))
    if case in ("tangent", "negative_disc"):
        b.sphere((0.0, 0.0, 0.0), 1.0, mat)
        if case == "tangent":
            offs = [(1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0)]
            o = [(-5.0, y, z) for y, z in offs for _ in range(3)]
            d = [(s, 0.0, 0.0) for _ in offs for s in (1.0, 2.0, 0.5)]
            o += [(-5.0, 0.3, -0.2), (-5.0, 0.0, 0.0), (-5.0, 1.5, 0.0), (-5.0, 0.0, -2.0)]
            d += [(1.0, 0.0, 0.0)] * 4
        else:
            r = rng.uniform(1.05, 3.0, 32)
            phi = rng.uniform(0.0, 2 * np.pi, 32)
            o = [(-5.0, ri * np.cos(p), ri * np.sin(p)) for ri, p in zip(r, phi)]
            d = [(1.0, 0.0, 0.0)] * 24 + [(-1.0, 0.0, 0.0)] * 8
            o[24:] = [(-5.0, 0.1 * k, 0.0) for k in range(8)]  # the sphere lies behind them
    elif case == "short_chunk":
        for k in range(13):
            b.sphere((2.0 * k, 0.0, 0.0), 0.5, mat)
        x = rng.uniform(-1.0, 25.0, 64)
        z = rng.uniform(-0.6, 0.6, 64)
        o = [(xi, 5.0, zi) for xi, zi in zip(x, z)]
        d = [(dx, -1.0, dz) for dx, dz in rng.uniform(-0.05, 0.05, (64, 2))]
    elif case == "equal_roots":
        for k in range(1, 9):
            b.sphere((0.0, 0.0, k - 0.5), 1.0, mat)
            b.sphere((0.0, 0.0, 0.5 - k), 1.0, mat)
        o = [(-5.0, y, 0.0) for y in np.linspace(-0.8, 0.8, 32)]
        d = [(1.0, dy, 0.0) for dy in np.linspace(-0.02, 0.02, 32)]
    else:
        raise ValueError(case)
    scene = b.compile(device)
    o = torch.tensor(np.array(o, np.float32), device=device)
    d = torch.tensor(np.array(d, np.float32), device=device)
    n = o.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=device)
    ray_f, ray_i = pack_rays(o, d, torch.zeros(n, device=device), idx, torch.zeros_like(idx))
    return build_mega_scene(scene), ray_f, ray_i


def random_scene(b, seed: int, n_spheres: int = 40, n_quads: int = 10, moving: bool = False):
    """tests/test_bvh.py's random scene in a SceneBuilder of either package."""
    rng = np.random.default_rng(seed)
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n_spheres):
        c = rng.uniform(-10, 10, 3)
        c2 = c + rng.uniform(-0.5, 0.5, 3) if moving and rng.random() < 0.5 else None
        b.sphere(tuple(c), rng.uniform(0.1, 2.0), m, center2=None if c2 is None else tuple(c2))
    for _ in range(n_quads):
        b.quad(tuple(rng.uniform(-10, 10, 3)), tuple(rng.uniform(-3, 3, 3)),
               tuple(rng.uniform(-3, 3, 3)), m)
    return b


def random_rays(seed: int, n: int = 512):
    """(o, d, time) numpy f32 rays through :func:`random_scene`'s volume."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-15, 15, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32), rng.random(n).astype(np.float32))


# rays along the axes: two direction components are 0 (the walk's 1e-20 clamp)
AXIS_RAYS = (np.array([[0, 0, 20], [20, 0, 0], [0, 20, 0], [-20, 0, 0]], np.float32),
             np.array([[0, 0, -1], [-1, 0, 0], [0, -1, 0], [1, 0, 0]], np.float32),
             np.zeros(4, np.float32))
BOX_OFFSET = (130.0, 7.5, -65.25)


def box_scene(b, translated: bool):
    """tests/test_translate.py's box and sphere at BOX_OFFSET: built inside
    ``translate`` or baked at the offset."""
    white = b.lambertian((0.73, 0.73, 0.73))
    if translated:
        with b.translate(BOX_OFFSET):
            b.box((0, 0, 0), (165, 165, 165), white)
            b.sphere((10, 20, 30), 40.0, white)
    else:
        b.box(np.add((0, 0, 0), BOX_OFFSET), np.add((165, 165, 165), BOX_OFFSET), white)
        b.sphere(np.add((10, 20, 30), BOX_OFFSET), 40.0, white)
    return b


def bilinear_grid(b):
    """A bilinear-filtered image on a sphere among 80 small spheres: more
    than 64 primitives that the megakernels' tables cannot express."""
    img = np.random.default_rng(5).random((6, 9, 3)).astype(np.float32)
    b.sphere((0.0, -100.0, 0.0), 99.5, b.lambertian((0.5, 0.5, 0.5)))
    b.sphere((0.0, 0.3, 0.0), 0.8, b.lambertian(b.image(img)))
    rng = np.random.default_rng(6)
    for k in range(80):
        b.sphere((rng.uniform(-4, 4), -0.35, rng.uniform(-4, 1)), 0.15,
                 b.lambertian(tuple(rng.random(3))))
    return b


def bvh_ray_sets(scene, cfg, seed: int = 7) -> dict:
    """Ray sets for the integrator's BVH walk, as (o, d, time) on the
    scene's device: ``"camera"``, the camera rays of a ``Renderer``'s
    first launch, and ``"bounce 1"``, the rays leaving their first bounce
    (the live ones after one brute-force bounce)."""
    from raytracing_tpu_torch.ops.intersect import closest_hit_brute
    from raytracing_tpu_torch.render import camera as cam
    from raytracing_tpu_torch.render import integrator
    from raytracing_tpu_torch.render.renderer import Renderer, chunk_rays

    dev = scene.spheres.radius.device
    r = Renderer(cfg, hit_method="bvh")
    o, d, t, pix, smp, _, alive = chunk_rays(
        cfg, cam.derive(cfg, cam.CameraParams.from_config(cfg, dev)), 0, 0, seed,
        n_block=r.n_block, spp_chunk=r.spp_chunk, has_moving=scene.flags.has_moving,
        device=dev)
    background = torch.tensor(cfg.background, dtype=torch.float32, device=dev)
    with torch.no_grad():
        st = integrator._bounce_once(scene, background, seed, closest_hit_brute,
                                     integrator.initial_state(o, d, t, pix, smp, alive), 0)
    live = st[7]
    return {"camera": (o, d, t), "bounce 1": tuple(x[live].contiguous() for x in st[:3])}


def noise_row(b):
    """tests/test_torch_traverse.py's gradient scene: marble spheres on a
    marble ground and a metal quad, whose geometry gradients are
    non-zero."""
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(b.noise(4.0)))
    for k in range(5):
        b.sphere((1.2 * k - 2.4, 0.5, 0.0), 0.5, b.lambertian(b.noise(2.0 + k)))
    b.quad((-3, 0, -2), (6, 0, 0), (0, 3, 0), b.metal((0.8, 0.7, 0.6), 0.2))
    return b


def noise_row_config(config_cls):
    return config_cls(aspect_ratio=1.0, image_width=16, samples_per_pixel=2, max_depth=3,
                      vfov=40.0, lookfrom=(0.0, 2.0, 7.0), lookat=(0.0, 0.5, 0.0),
                      background=(0.7, 0.8, 1.0))
