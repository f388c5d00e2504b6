"""Ray Tracing in One Weekend's final scene with moving spheres (The Next
Week, ``bouncing_spheres``), as a plain recipe: a checker ground, a 22×22
grid of small spheres whose material, position and colour come from
``numpy.random.default_rng(grid_seed)`` (80% lambertian moving up by
U[0, 0.5) over the shutter, 15% metal, 5% glass), and the three large
spheres."""
import numpy as np


def build(conf, s):
    ground = s.lambertian(s.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    s.sphere((0.0, -1000.0, -1.0), 1000.0, ground)
    rng = np.random.default_rng(conf["grid_seed"])
    lo, hi = conf["grid"]
    for a in range(lo, hi):
        for b in range(lo, hi):
            choose_mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.random(3) * rng.random(3)
                center2 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
                s.sphere(tuple(center), 0.2, s.lambertian(tuple(albedo)), center2=tuple(center2))
            elif choose_mat < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                s.sphere(tuple(center), 0.2, s.metal(tuple(albedo), rng.uniform(0.0, 0.5)))
            else:
                s.sphere(tuple(center), 0.2, s.dielectric(1.5))
    s.sphere((0.0, 1.0, 0.0), 1.0, s.dielectric(1.5))
    s.sphere((-4.0, 1.0, 0.0), 1.0, s.lambertian((0.4, 0.2, 0.1)))
    s.sphere((4.0, 1.0, 0.0), 1.0, s.metal((0.7, 0.6, 0.5), 0.0))
